"""LM zoo on PyTorch: the decoder-only families dense, moe, ssm and hybrid
(ROADMAP A17; encdec and vlm wait for its item 4).

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    model = build_model(get_config("yi-9b"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, hidden, caches = model.prefill(params, {"tokens": tokens}, cache_len=256)
"""
