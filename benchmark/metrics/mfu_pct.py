"""Model step: the model's operations on the frames completed in the
window (counted from the configuration's shapes by its family's
`model_flops`, whatever implements them; the backbone's only where the
traffic sends images) over the window's wall time and the card's
published peak for the configuration's compute dtype (989 TFLOP/s bf16,
67 TFLOP/s float32: TF32 is off)."""

from fvpbench import counts


def read(run):
    if run.window_s <= 0 or not run.frames:
        return None
    flops = run.cell.family.model_flops(run.config, run.cell.sends_images)["frame"] \
        * run.frames
    peak = counts.PEAKS[run.config["config"]["compute_dtype"]]
    return 100.0 * flops / run.window_s / peak
