"""Device ms per step launched inside the optimizer's step."""
from benchmark.readers import device_ms_per

SPANS = ("sixdgs_torch.pose.trainer.Adafactor.step",)


def read(trace):
    return device_ms_per(trace, SPANS[0], "steps")
