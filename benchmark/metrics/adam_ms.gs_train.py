"""Device ms per timed step launched inside the trainer's Adam update."""
from benchmark import readers_gs

SPANS = readers_gs.SPANS + ("sixdgs_torch.train.gs_trainer.adam_update",)


def read(trace):
    return readers_gs.device_ms_per_step(trace, SPANS[-1])
