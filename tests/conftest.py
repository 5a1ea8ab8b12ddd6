def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips elsewhere "
        "(run them with: python -m pytest -m cuda tests/test_torch_kernels.py)",
    )
