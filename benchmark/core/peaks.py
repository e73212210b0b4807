"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet for the H100 SXM
part: dense bf16 products, HBM3 bandwidth, at its 700 W limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flops_per_s=989e12, hbm_bytes_per_s=3.35e12),
}


def of(kind: str):
    """The peaks of card ``kind``, or None (a metric against a peak is then
    left out)."""
    return PEAKS.get(kind)
