"""Published peaks of the cards the benchmark knows, by the name
`torch.cuda.get_device_name()` gives (NVIDIA's data sheet, SXM part, dense
rates, at the full 700 W power limit). A card not listed has no roofline
or MFU metric: its readers report nothing."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops_per_s": 67e12, "bytes_per_s": 3.35e12},
}
