"""pipeline_other_s: host seconds per scan of the completion pipeline's
stages other than sampling (crop and FPS, postprocess, refine), from
`DiffCompletion.times` of the traced scans. Each of those stages ends in a
copy to the host, so its time includes the card's work."""


def read(layer: dict):
    times = layer.get("stage_times")
    if not times:
        return None
    return sum(t["preprocess"] + t["postprocess"] + t["refine"]
               for t in times) / len(times)
