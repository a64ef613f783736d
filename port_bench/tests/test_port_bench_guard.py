"""The check that nothing of JAX or of the JAX package is loaded, by whole top-level names."""

import os
import subprocess
import sys

from port_bench.lib.guard import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_whole_top_level_names():
    assert forbidden_modules(["triplaneturbo_torch", "triplaneturbo_torch.ops.flash_attention",
                              "jaxtyping", "flaxen", "benchmarks_x"]) == []
    assert forbidden_modules(["triplaneturbo_tpu.ops", "jax._src.core", "flax.linen",
                              "optax", "jaxlib", "bench"]) == sorted(
        ["triplaneturbo_tpu", "jax", "flax", "optax", "jaxlib", "bench"])


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.run, port_bench.calibrate\n"
            "from port_bench.lib import serve, train, guard\n"
            "serve.build_program, train.build_program\n"
            "import triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d\n"
            "import triplaneturbo_torch.systems.builder, triplaneturbo_torch.systems.prompt_setup\n"
            "print(guard.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "port_bench", "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                for bad in ("import triplaneturbo", "from triplaneturbo", "import jax",
                            "from jax", "import flax", "from flax"):
                    assert bad not in text, (f, bad)


def test_no_card_no_result_and_no_program_no_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "serve-b1",
                          "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "serve-b1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**env, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
