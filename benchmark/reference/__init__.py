"""The plain reference of the benchmark: DIORA / CLIORA in plain PyTorch.

It is a frozen, standalone statement of the model's arithmetic, written
from the published equations and the program's documented conventions
(chart layout, tie rules, the dropout stream's seeds), with no kernel,
no cache, no graph and no batching of its own.  It imports nothing of
the program and nothing of the JAX package: the benchmark hands it the
same weights and inputs it hands the program, and it works out again
whatever the program derives from them.
"""
