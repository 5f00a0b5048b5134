"""pad_share.ptv3: the share of Point Transformer V3's attention rows that
are filler (copies that complete an element's last patch), by the
program's own counters over the traced steps' attention calls."""


def read(layer: dict):
    c = layer.get("ptv3_counters")
    if not c or not c.get("attn_rows"):
        return None
    return 100.0 * c["attn_filler"] / c["attn_rows"]
