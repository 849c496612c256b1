"""Share of the traced window's wall time inside PoseTrainer.validate."""
SPANS = ("sixdgs_torch.pose.trainer.PoseTrainer.validate",)


def read(trace):
    calls = trace.span_calls(SPANS[0])
    return 100.0 * trace.span_wall_s(SPANS[0]) / trace.window_s if calls else None
