"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib``, ``ml_dtypes`` or anything of
the JAX package ``repro`` (only the tests import both).  An AST scan, so
imports inside functions count too."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in _files()}
    assert {"scheduler.py", "engine.py", "kv_cache.py", "ops.py", "chip_smoke.py",
            "weights.py", "bstc.py", "roofline.py", "interop.py", "attention.py",
            "transformer.py", "brcr.py", "quantization.py", "topk.py", "synthetic.py",
            "quickstart.py", "bgpp_sparse_attention.py", "spec_decode.py", "model_zoo.py",
            "shapes.py", "gemma3_4b.py", "deepseek_7b.py", "whisper_medium.py",
            "moe.py", "mamba2.py", "whisper.py", "server.py", "serve_llm.py",
            "adamw.py", "schedules.py", "train_step.py", "pipeline.py", "checkpointer.py",
            "fault_tolerance.py", "train.py", "train_llm.py", "tree.py"} <= names
    for k in ("flash_attention", "bgpp_score", "brcr_gemm"):
        assert PORT / "kernels" / k / "ops.py" in _files()
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == [
        "bgpp_paged_attend.cu", "bgpp_paged_attend_long.cu", "bgpp_score.cu", "brcr_gemm.cu",
        "bstc_decode.cu",
        "bstc_matmul.cu", "flash_attention.cu", "flash_attention_bwd.cu", "paged_flash_decode.cu",
        "paged_flash_decode_long.cu"]
