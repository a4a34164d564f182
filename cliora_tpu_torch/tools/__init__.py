"""The measuring tools of the port, one module per tool, each run as
``python -m cliora_tpu_torch.tools.<name>`` (counterparts of the JAX
package's ``tools/*.py`` of the same names).  Each keeps its JAX tool's
flags and human lines and ends with one JSON line; a tool that measures
the card refuses to run without one unless it is given ``--device cpu``
(common.py)."""
