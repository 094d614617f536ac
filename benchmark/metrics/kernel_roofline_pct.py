"""Kernels: the least time of every launch of the program's hand-written
kernels in the traced window (the family's `kernel_bounds`: bytes over
3.35 TB/s or operations over the peak of the kernel's arithmetic, from
the launch's shapes) over their measured device time. The launches are
the program's own counters; the device times are the trace's events of
the kernels' CUDA symbols (the family's `SYMBOLS`). Returns nothing
when a kernel ran that has no bound here, or when the trace and the
counters disagree."""


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    fam = run.cell.family
    bounds = fam.kernel_bounds(run.config, run.batch,
                               fam.sampled_people(run),
                               run.cell.sends_images)
    least = 0.0
    for name, n in run.launches.items():
        if name not in bounds or n != bounds[name][0] * tr.calls:
            run.notes.append(f"kernel_roofline_pct: {name} launched {n} "
                             f"times in {tr.calls} batches, no bound here")
            return None
        least += bounds[name][1]
    measured, events = 0.0, 0
    for name, dur in ((n, d) for n, _, d, _, k in tr.ops if k):
        if name.rsplit("::", 1)[-1] in fam.SYMBOLS:
            measured += dur
            events += 1
    if events != sum(run.launches.values()) or measured <= 0:
        run.notes.append(f"kernel_roofline_pct: {events} kernel events in "
                         f"the trace, {sum(run.launches.values())} launches "
                         "counted")
        return None
    return 100.0 * least * 1e-3 / measured
