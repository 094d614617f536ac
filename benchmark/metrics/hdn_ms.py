"""HDN: device milliseconds a batch of the kernels launched inside the
model's `detect`, from the traced window."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not tr.calls \
            or not tr.spans.get("detect"):
        return None
    return 1e3 * tr.kernel_s("detect") / tr.calls
