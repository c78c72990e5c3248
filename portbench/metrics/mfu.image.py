"""The whole sampler step's share (%) of the chip's bf16 peak: the model FLOPs
of a step counted from the configuration's shapes
(``portbench.counts.step``: every product of FLUX and the ControlNets at the
step's rows) over the ``sample`` stage's seconds per step times 989 TFLOP/s,
over all traced requests."""

from portbench.counts import PEAK_BF16_FLOPS


def read(record):
    reqs = [r for r in record["requests"] if "sample" in r["timings"]]
    seconds = sum(r["timings"]["sample"] for r in reqs)
    steps = sum(r["steps"] for r in reqs)
    if not seconds or not steps:
        return None
    return 100.0 * record["step_flop"] * steps / seconds / PEAK_BF16_FLOPS
