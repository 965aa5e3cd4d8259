"""The plain reference: numpy and plain PyTorch, independent of the program.

It imports nothing of the program under test (nor ``jax``, nor the JAX
package), takes only the tables the benchmark made and the outputs it
judges, and works out everything else again.
"""
