"""Device ms per image launched inside the program's ray MLP stage
(``sixdgs:pose.ray_mlp``) in the traced window."""
from benchmark.readers import device_ms_per


def read(trace):
    return device_ms_per(trace, "sixdgs:pose.ray_mlp", "images")
