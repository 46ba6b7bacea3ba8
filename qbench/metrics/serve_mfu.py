"""The served batch's model FLOPs (the forward pass in eval mode, on the sampled
blocks' valid sizes, ``costs/flops.py``) a second of the traced slice,
as a share of the published peak of the precision the fp32 matmuls run
in (fp32 unless TF32 is switched on)."""

from qbench.costs import peaks


def read(s):
    flops = s.facts.get("model_flops")
    if not flops or s.window_s <= 0:
        return None
    return 100.0 * flops / s.window_s / peaks.matmul_peak(s.facts["tf32"])
