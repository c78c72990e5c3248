"""The whole sampler step's share (%) of the chip's bf16 peak, over the
traced requests as ``mfu.image`` reads its cell: the step's model FLOPs,
FLUX and the RepText ControlNet (``record["step_flop"]``) plus the
inpainting ControlNet (``controlnet_inpaint_flop`` in each request's
timings, which the inpainting driver counts from the net the run built:
the record carries no configuration), every net at the cell's rows, over
the ``sample`` stage's seconds per step times 989 TFLOP/s. None for a
request that carries no such count."""

from portbench.counts import PEAK_BF16_FLOPS


def read(record):
    reqs = [r for r in record["requests"]
            if "sample" in r["timings"] and "controlnet_inpaint_flop" in r["timings"]]
    seconds = sum(r["timings"]["sample"] for r in reqs)
    if not seconds:
        return None
    flop = sum((record["step_flop"] + r["timings"]["controlnet_inpaint_flop"]) * r["steps"]
               for r in reqs)
    return 100.0 * flop / seconds / PEAK_BF16_FLOPS
