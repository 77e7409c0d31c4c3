"""Device half of the port: planner, packers, runner and kernels."""
