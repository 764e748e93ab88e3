"""Plain references of the benchmark's configurations.

Plain PyTorch on any device and dtype.  Nothing here imports the program
under test or the JAX package: the references work everything out again
from the generated inputs and read the program's outputs only to judge
them.
"""
