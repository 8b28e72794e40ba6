"""The benchmark's plain reference of BiSwift's round trip: plain PyTorch
and numpy, importing nothing of the program it judges."""
