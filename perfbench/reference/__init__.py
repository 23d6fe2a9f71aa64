"""The plain reference the benchmark judges the program by: plain PyTorch
in float32, importing nothing of the program."""
