"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
dense rates without sparsity, at the full power limit), frozen here so that
the yardstick does not move with the program."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "float32_flops": 67e12,  # outside the tensor cores
        "tf32_flops": 495e12,
        "bfloat16_flops": 989e12,
    },
}


def peaks(kind: str) -> dict:
    """The peaks of a card by its ``torch.cuda.get_device_name()``; an H100
    of another variant reads as the SXM part's."""
    if kind in PEAKS:
        return PEAKS[kind]
    if "H100" in kind:
        return PEAKS["NVIDIA H100 80GB HBM3"]
    raise KeyError(f"no published peaks for {kind!r}")


def matmul_peak(kind: str, compute_dtype: str, tf32: bool) -> float:
    """FLOP/s of the matrix products in the configuration's stated precision."""
    p = peaks(kind)
    if compute_dtype == "bfloat16":
        return p["bfloat16_flops"]
    return p["tf32_flops"] if tf32 else p["float32_flops"]
