"""Device ms per image of the scorer wrapper's own work at a padded shape
(784 x 256): the device time launched inside attention_scores_fwd less
that launched inside the one-chunk launches it makes (_launch_fwd). What
is left is the padding, the chunks' sums, the concatenations and the
slices, the work the program's span ``scorer.pad`` covers. Read through
these function paths, not through that span's ``sixdgs:scorer.pad``
range, which the harness's trace does not keep: the paths need no new
function in the program, so a program without the span reads alike. Each
launch's own copy of the transposed padded Wk (``_aligned``) counts with
the launch."""
from benchmark.readers import FWD

LAUNCH_FWD = "sixdgs_torch.ops.attention_kernel._launch_fwd"
SPANS = (FWD, LAUNCH_FWD)


def read(trace):
    images = trace.work.get("images", 0)
    if not len(trace.kernels) or not images or not trace.span_calls(LAUNCH_FWD):
        return None
    return 1e3 * (trace.span_device_s(FWD) - trace.span_device_s(LAUNCH_FWD)) / images
