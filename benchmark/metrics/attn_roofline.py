"""attn_roofline: the attention's least time over the traced steps over its
kernels' device time in the trace, in %. The least time of one image's
forward is the reference model's `attention_bound_s` over its attentions'
shapes (`attention_shapes`): for each, the larger of its QKᵀ and PV
operations at the peak of the kernels below (float32 as three TF32
tensor-core products, as the configuration's `precision` states: 495/3
TF/s) and its Q, K, V and O bytes at HBM3's 3.35 TB/s. It is counted on
each of a traced step's forward-equivalents, as `mfu` counts them (the
configuration's `step_flops`: a backward twice its forward, the gated
forward only on the steps whose gate fired), for every image of the batch.
The kernels are those `onda_torch.ops.attention.sr_attention` launches,
forward and backward, by name. Nothing to read where the model has no attention or no
such kernel ran."""

from benchkit import counts
from benchkit.trace import seconds_of

KERNELS = ("fmha_cutlassF", "fmha_cutlassB")  # the memory-efficient kernel, float32
PEAK = counts.TF32_FLOPS / 3  # its float32 product: three TF32 products


def read(run):
    log, cell = run.logger, run.cell
    module = cell.model.module
    if log.summary is None or not hasattr(module, "attention_shapes"):
        return None
    device_s = seconds_of(log.summary["kernel_s"], KERNELS)
    if device_s <= 0:
        return None
    calls = module.attention_shapes(**cell.model.shape, hw=tuple(cell.hw))
    per_image = module.attention_bound_s(calls, PEAK, counts.HBM_BYTES_PER_S)
    spec, (first, last) = cell.config["step_flops"], log.trace_steps
    equivalents = sum(spec["model"] + (spec.get("gated", 0) if fired else 0)
                      for fired in log.fired[first:last])
    return 100.0 * equivalents * cell.batch * per_image / device_s
