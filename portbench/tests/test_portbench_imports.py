"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port."""
import json
import os
import subprocess
import sys

from .conftest import ROOT

PKG = os.path.join(ROOT, "portbench")


def modules():
    out = []
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = [d for d in dirnames
                       if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def loaded_after(code):
    """The top-level names of the modules a fresh interpreter has loaded
    after running ``code``."""
    prog = code + ("\nimport json, sys\nprint(json.dumps(sorted("
                   "{m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.splitlines()[-1]))


def test_every_module_imports_without_jax():
    mods = modules()
    assert {"portbench.run", "portbench.client",
            "portbench.reference.work"} <= set(mods)
    names = loaded_after("\n".join("import %s" % m for m in mods))
    assert not names & {"jax", "jaxlib", "flax", "xvc_tpu"}


def test_reference_decodes_without_the_port():
    names = loaded_after(
        "from portbench.reference import work\n"
        "work.decode(open('portbench/tests/data/ld64x48.xvc', 'rb').read())")
    assert not names & {"xvc_tpu_torch", "xvc_tpu", "jax", "jaxlib", "torch"}


def test_names_compared_whole():
    """``xvc_tpu_torch`` is not ``xvc_tpu``: the check compares top-level
    names whole."""
    from portbench import harness
    saved = dict(sys.modules)
    try:
        sys.modules["xvc_tpu_torch_fake.sub"] = object()
        assert "xvc_tpu_torch_fake.sub" not in harness.forbidden_modules()
        sys.modules["xvc_tpu.codec"] = object()
        assert "xvc_tpu.codec" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
