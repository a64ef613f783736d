"""A frozen copy of ``triplaneturbo_torch``'s model, renderer, guidance and trainer
code, the benchmark's plain reference.

Copied with relative imports and all, and these changes: ``ops/flash_attention.py``
and ``ops/field_grid.py`` are the plain versions (no hand-written kernel, no build),
every ``torch.utils.checkpoint`` goes through ``ops/sites.py`` (which marks the
backward's recompute for the work count), and what no cell drives is left out: the
exporters, converters, checkpoint readers, native writer, demo, evaluation, tools,
data parallelism, the FLOP count, the CLIP image tower, and the trainer's monolithic
step, stacked renderers and validation renders (``systems/trainer.py`` follows the
staged v1 step in one process). It imports ``torch``, numpy and the standard library only.
"""
