"""The repository's linter over the port: ``repro.analysis.lint`` finds no
diagnostic in ``src/repro_torch``, ``chip_smoke.py``, the example
scripts of ``examples_torch/`` and ``tests/test_torch_ssm_train.py``.
Its rules keyed
on basenames (the lock order cluster -> drive -> hub in
``cluster_loop.py``, fault purity in ``runtime.py``, guarded hub calls in
``serve_loop.py`` / ``cluster_loop.py`` / ``runtime.py``) reach the port's
copies of those modules through their names."""
from pathlib import Path

from repro.analysis.lint import run_lint

ROOT = Path(__file__).resolve().parents[1]


def test_port_is_clean_under_the_linter():
    report = run_lint([str(ROOT / "src" / "repro_torch"),
                       str(ROOT / "chip_smoke.py"),
                       str(ROOT / "examples_torch"),
                       str(ROOT / "tests" / "test_torch_ssm_train.py")])
    names = {Path(f).name for f in report.files}
    assert {"cluster_loop.py", "runtime.py", "serve_loop.py",
            "chip_smoke.py", "serve_nlp_queries.py", "quickstart.py",
            "isp_embedding_demo.py", "train_lm.py", "apps.py",
            "test_torch_ssm_train.py"} <= names
    assert report.errors == [], "\n".join(d.format() for d in report.errors)
    assert report.diagnostics == [], "\n".join(
        d.format() for d in report.diagnostics)
