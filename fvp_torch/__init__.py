"""fvp_torch: the PyTorch + CUDA port of fvp_tpu for one NVIDIA H100.

It serves frames (heatmaps or images -> fused poses) through
`fvp_torch.engine.serve.Predictor`, and evaluates datasets through
`fvp_torch.engine.validate.run_validation` (CLI: run/validate_torch.py).
The kernels live in `csrc/` and are wrapped in `ops/kernels/`.
"""
