"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``occnet_tpu_torch`` is the port)."""

import glob
import os
import subprocess
import sys

from occbench import harness


def test_benchmark_modules_load_no_jax():
    mods = []
    for path in glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                          recursive=True):
        rel = os.path.relpath(path, harness.ROOT)
        if "/tests/" in rel or "/metrics/" in rel:
            continue
        mods.append(rel[:-3].replace(os.sep, "."))
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from occbench import harness\n"
        "for m in harness.benchmark()['per_layer']:\n"
        "    harness.load_module('metrics', m['name'])\n"
        "import occnet_tpu_torch.serve, occnet_tpu_torch.training.train\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
