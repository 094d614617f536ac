"""Serving engine: host milliseconds from a batch's `predictor(batch)`
call to its return (the pageable host-to-device copy and the enqueue of
the step), mean over the window's batches."""


def read(run):
    if not run.submits:
        return None
    return 1e3 * sum(run.submits) / len(run.submits)
