"""Published peaks of the cards a run may report (NVIDIA's data sheets,
dense rates, at the full power limit), looked up by device name."""

from __future__ import annotations

__all__ = ["peaks_for"]

PEAKS = {
    # H100 SXM: 80 GB HBM3 at 3.35 TB/s; float32 outside the tensor cores
    "H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12, "bf16_flops": 989e12,
             "int8_ops": 1979e12},
}


def peaks_for(device_name: str) -> dict | None:
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None
