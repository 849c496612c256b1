"""Wall ms per ray renewal inside PoseTrainer._regen_rays."""
from benchmark.readers import wall_ms_per_call

SPANS = ("sixdgs_torch.pose.trainer.PoseTrainer._regen_rays",)


def read(trace):
    return wall_ms_per_call(trace, SPANS[0])
