"""The benchmark of the PyTorch and CUDA planner (``perfbench/run.py``)."""
