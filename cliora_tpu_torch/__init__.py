"""PyTorch/CUDA port of cliora_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one: it imports ``torch`` and never
``jax`` or ``cliora_tpu``, keeping its own copies of the host code it
needs.  Module names follow the JAX package so each module's
counterpart is easy to find.

Ported so far:

* the text-only DIORA parse path -- ``training.trainer.Trainer.parse`` ->
  ``models.diora`` embed + leaf transform ->
  ``ops.inside_cky.fused_inside_cky`` (a hand-written CUDA kernel,
  ``csrc/inside_cky.cu``) or the plain ``ops.chart_pass`` inside pass ->
  ``analysis.trees.decode_batch`` (the C decoder in ``native/``);
* the DIORA / CLIORA train step -- ``training.trainer.Trainer.step`` ->
  embed, image encoder, leaf transform with region attention ->
  ``ops.chart_pass`` inside and outside passes -> ``training.losses``,
  with the span x region max of ``ops.span_region`` (three hand-written
  CUDA kernels, ``csrc/span_region.cu``) -> backward -> global-norm clip
  -> Adam;
* the CLIORA parse and its eval -- ``Trainer.parse`` with the span x
  region scores, charts and losses on request (the plain route) ->
  ``analysis.trees`` decode and span F1, ``analysis.grounding``,
  ``analysis.eval.run_eval``;
* parameter checkpoints -- ``training.checkpoint`` ``.npz`` files shared
  with the JAX package, and the reference's ``.pt`` state dicts;
* data-parallel training across processes -- ``parallel.multihost``
  (the ``torch.distributed`` group), ``parallel.mesh`` (the dp group and
  the collectives the global batch's losses need), ``parallel.sharding``
  (ZeRO-1) and ``training.dist_ckpt`` (sharded async checkpoints).

Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
