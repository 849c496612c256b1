"""Device ms per image launched inside the backbone's forward, as
score_image calls it: preprocessing and the eager SuperPoint CNN."""
from benchmark.readers import device_ms_per

SPANS = ("sixdgs_torch.pose.id_module.backbone_features",)


def read(trace):
    return device_ms_per(trace, SPANS[0], "images")
