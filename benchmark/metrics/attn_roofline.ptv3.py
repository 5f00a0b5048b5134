"""attn_roofline.ptv3: the least time of the traced steps' attention on
the card over the device time of the attention kernels (SDPA's flash
kernels, by name). The least time is the attention's FLOPs over the dense
bf16 peak (989 TFLOP/s): 4 K 16 FLOP per padded row, head and block
forward and 2.5 times that backward, the padded rows counted from the
reference's own patch maps of each traced batch
(`benchmark/work_ptv3.py`). At head dimension 16 a patch's scores are
computed from 32 bytes a row, so the bound is the FLOPs."""

from benchmark import work_ptv3


def read(layer: dict):
    t, cnt, model = (layer.get("trace"), layer.get("ptv3_counts"),
                     layer.get("ptv3_model"))
    if t is None or not cnt or model is None:
        return None
    ks = [k for k in t.kernels if "flash" in k.name.lower()]
    busy = sum(k.end - k.start for k in ks) * 1e-6
    if busy <= 0:
        return None
    flops = 3.5 * sum(work_ptv3.attention_flops(c, model) for c in cnt)
    return 100.0 * flops / (work_ptv3.PEAK_BF16 * busy)
