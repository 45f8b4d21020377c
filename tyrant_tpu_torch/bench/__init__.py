from .harness import PoseResult, results_to_dict, run_benchmark  # noqa: F401
