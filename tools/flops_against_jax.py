"""The tiny training step's FLOPs in the port beside the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/flops_against_jax.py

Produces a number for ``PERF.md`` only; nothing holds it. Prints one JSON line: the
tiny staged step of ``tests/test_torch_train_step.py`` counted by the port's
``step_cost_flops`` (by program) and by the JAX trainer's, which sums XLA's
``cost_analysis`` over the programs it dispatches, each counting its loops' bodies
once, and the ratio of the two. The prompt's counts are printed by
``tests/test_torch_flops.py::test_pipeline_count_against_the_jax_cost_analysis``
(``pytest -s``), which holds them. Takes about three minutes (XLA compiles every
program of the step).
"""

import json
import os
import sys
import time

import jax
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))

from test_torch_flops import _step_args  # noqa: E402
from test_torch_train_step import step_inputs, tiny_config  # noqa: E402
from triplaneturbo_tpu.systems.builder import build_system as jax_build_system  # noqa: E402
from triplaneturbo_torch.systems.builder import build_system  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    batch_list, text = _step_args()
    port = build_system(tiny_config(True), device="cpu").step_cost_flops(
        batch_list, text, torch.Generator().manual_seed(1))
    jbatch, jtext = step_inputs(0)
    xla = jax_build_system(tiny_config(True)).step_cost_flops(jbatch, jtext,
                                                              jax.random.PRNGKey(1))
    print(json.dumps({"port_flops": port.total, "port_by_program": port.by_range,
                      "xla_flops": xla, "port_over_xla": port.total / xla,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
