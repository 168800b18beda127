"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's)."""

import subprocess
import sys

from benchmark import harness

SCRIPT = """
import importlib, json, sys
sys.path.insert(0, {root!r})
from benchmark import control, devtrace, harness, roofline, run, training
import linear_operator_tpu_torch
m = harness.load_manifest()
for w in m["workloads"]:
    c = harness.resolve(m, w["name"])
    importlib.import_module("benchmark.systems." + c.config["system"])
    importlib.import_module("benchmark.loops." + c.traffic["loop"])
for p in m["per_layer"]:
    harness.load_module("metrics", p["name"])
import benchmark.reference.exact_gp, benchmark.reference.love
print(json.dumps(sorted({{k.split(".", 1)[0] for k in sys.modules}})))
"""


def test_no_jax_module_is_loaded():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(harness.ROOT))], capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0", "HOME": str(harness.ROOT)})
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN_MODULES)
    assert "linear_operator_tpu_torch" in loaded


def test_the_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "linear_operator_tpu" not in text.replace("\n", " ").split('"""')[-1], path
        assert "import jax" not in text
