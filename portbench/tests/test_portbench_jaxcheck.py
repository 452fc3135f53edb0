"""The end-of-run check against the JAX stack compares top-level names
whole."""

import run


def test_the_port_passes_and_the_jax_package_fails():
    assert run.forbidden_modules(["veneur_tpu_torch", "veneur_tpu_torch.ops",
                                  "numpy", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["veneur_tpu.ops", "veneur_tpu"]) == [
        "veneur_tpu", "veneur_tpu.ops"]
    assert run.forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen"]) \
        == ["flax.linen", "jax", "jaxlib.xla_client"]


def test_harness_sources_import_no_jax():
    import ast
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for d, _, files in os.walk(root):
        if "_cache" in d:
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                assert not run.forbidden_modules(names), (f, names)
