"""Wall ms per call inside solve_pose, as eval_image calls it."""
from benchmark.readers import wall_ms_per_call

SPANS = ("sixdgs_torch.pose.evaluate.solve_pose",)


def read(trace):
    return wall_ms_per_call(trace, SPANS[0])
