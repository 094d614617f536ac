"""The port's tools, run as `python -m fvp_torch.tools.<name>`: the
dataset tools (extract_training_poses, preprocess, check_space_center,
check_midpoint_hypothesis, visualize_cameras, train_supervisor; fixtures
writes synthesised dataset trees) and the kernel measurement script
(kernel_parts, on the card from the repo root)."""
