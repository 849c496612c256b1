"""Device operations (kernels, copies, sets) the host launched per timed
training step."""
from benchmark.readers_gs import SPANS, launches_per_step as read  # noqa: F401
