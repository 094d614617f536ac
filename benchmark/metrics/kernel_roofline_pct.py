"""Kernels: the least time of every launch of the program's hand-written
kernels in the traced window (fvpbench.counts: bytes over 3.35 TB/s or
operations over the peak of the kernel's arithmetic, from the launch's
shapes) over their measured device time. The launches are the program's
own counters; the device times are the trace's events of the kernels'
CUDA symbols. Returns nothing when a kernel ran that has no bound here,
or when the trace and the counters disagree."""

from fvpbench import counts

# CUDA symbol -> the counters (fvp_torch.ops.kernels.all_kernels names)
# whose launches run it
SYMBOLS = {
    "whole_sample_kernel": ("whole_sample", "whole_sample.sum"),
    "person_layout_kernel": ("person_planes.layout",),
    "person_planes_kernel": ("person_planes",),
    "centernet_kernel": ("centernet",),
    "centernet_bf16_kernel": ("centernet_bf16",),
    "soft_argmax_kernel": ("soft_argmax",),
    "weightnet_pool_kernel": ("weightnet_pool",),
    "weightnet_pool_bf16_kernel": ("weightnet_pool_bf16",),
    "stem_kernel": ("stem",),
    "deconv_stage_kernel": ("deconv_stage",),
    "conv_wgmma_kernel": ("bottleneck_stage.wgmma", "p2pnet.conv.wgmma",
                          "centernet_bf16.conv.wgmma"),
    "conv_bf16_kernel": ("bottleneck_stage.wmma", "p2pnet.conv.wmma",
                         "centernet_bf16.conv.wmma"),
    "maxpool2_bf16_kernel": ("p2pnet.pool", "centernet_bf16.pool"),
    "c2cnet_kernel": ("c2cnet",),
}


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    bounds = counts.kernel_bounds(run.config, run.batch,
                                  run.sampled_people())
    least = 0.0
    for name, n in run.launches.items():
        if name not in bounds or n != bounds[name][0] * tr.calls:
            run.notes.append(f"kernel_roofline_pct: {name} launched {n} "
                             f"times in {tr.calls} batches, no bound here")
            return None
        least += bounds[name][1]
    measured, events = 0.0, 0
    for name, dur in ((n, d) for n, _, d, _, k in tr.ops if k):
        if name.rsplit("::", 1)[-1] in SYMBOLS:
            measured += dur
            events += 1
    if events != sum(run.launches.values()) or measured <= 0:
        run.notes.append(f"kernel_roofline_pct: {events} kernel events in "
                         f"the trace, {sum(run.launches.values())} launches "
                         "counted")
        return None
    return 100.0 * least * 1e-3 / measured
