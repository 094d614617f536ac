"""The plain reference of the benchmark: Faster-VoxelPose (HDN + JLN) and
its Pose-ResNet backbone in plain PyTorch, float32 with TF32 off.

A frozen copy written from the model's published description and the
reference package's layer equations. It imports nothing of the measured
program and takes nothing the program made: from the configuration, the
camera rig and the state dicts it works out its own rig constants, grids
and folded BatchNorms. `precision` lowers its convs and matmuls to TF32 or
fp8 for the control runs that prove the comparison fails on them.
"""
