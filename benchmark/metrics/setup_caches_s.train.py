"""Seconds of set-up in the trainer's two caches: the host images
(``setup.image_cache``) and the backbone features over the device images
(``setup.feature_cache``)."""
from benchmark.program_spans import snapshot

STAGES = ("setup.image_cache", "setup.feature_cache")


def read(trace):
    snap = snapshot(trace, "setup")
    spans = snap["spans"] if snap else {}
    if not all(s in spans for s in STAGES):
        return None
    return sum(spans[s]["total_ms"] for s in STAGES) * 1e-3
