"""The reference's two examples on the port: ``quickstart`` (an SPD system
by sync RGS, async RGS at beta~ and CG) and ``solve_regression``
(multi-target least squares by randomized Kaczmarz).  Each runs as
``python -m repro_torch.examples.<name> [--device cpu]``."""
