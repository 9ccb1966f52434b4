"""Package rules of the port: ``repro_torch`` and its chip scripts import
neither ``jax`` nor anything of ``repro``; importing the port loads no JAX;
the entry points default to the card and raise where there is none;
``chip_smoke.py`` fails without a card and outside a checkout."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_profile.py"]


def _absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _absolute_imports(path)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _run(args, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_importing_the_port_loads_no_jax():
    res = _run(["-c", "import sys, repro_torch, repro_torch.kernels.ops, "
                "repro_torch.core.blocksort, repro_torch.configs, "
                "repro_torch.data, repro_torch.runtime, "
                "repro_torch.kernels.runmerge_kernel, "
                "repro_torch.kernels.kway_kernel, repro_torch.pipeline, "
                "repro_torch.pipeline.ingest, repro_torch.pipeline.merge, "
                "repro_torch.pipeline.manifest, "
                "repro_torch.pipeline.validate, "
                "repro_torch.pipeline.histogram, "
                "repro_torch.pipeline.shards, repro_torch.checkpoint, "
                "repro_torch.checkpoint.manager, "
                "repro_torch.runtime.failure, "
                "repro_torch.runtime.straggler, "
                "repro_torch.runtime.sortfault, "
                "repro_torch.runtime.chaos, repro_torch.parallel, "
                "repro_torch.parallel.compat, repro_torch.core.bitonic, "
                "repro_torch.core.distributed, repro_torch.core.oets, "
                "repro_torch.models, repro_torch.models.moe, "
                "repro_torch.serve, repro_torch.launch.serve, "
                "repro_torch.parallel.sharding, repro_torch.data.bucketing, "
                "repro_torch.data.loader, repro_torch.launch.dryrun, "
                "repro_torch.launch.hillclimb, repro_torch.launch.enrich, "
                "repro_torch.testing; "
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'repro')]; print(bad); "
                "sys.exit(1 if bad else 0)"])
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_the_card():
    """Here, where there is no card, the default device raises; on a card
    the same call sorts."""
    import numpy as np
    from repro_torch import bucketed_sort_words, bucketize_packed, \
        chunked_sort_packed, chunked_sort_words, sorted_packed
    from repro_torch.core.distributed import distributed_chunked_sort_lex
    from repro_torch.interop import run_to_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_cache, init_lm
    from repro_torch.pipeline import sorted_run
    from repro_torch.serve import BucketedScheduler, Request
    cfg = get_smoke_config("granite-moe-1b-a400m")
    words = ["pear", "fig", "apple", "kiwi"]
    keys = np.array([[1], [2]], np.uint32)
    if torch.cuda.is_available():
        assert bucketed_sort_words(words) == ["fig", "kiwi", "pear", "apple"]
        return
    for call in (lambda: bucketed_sort_words(words),
                 lambda: bucketed_sort_words([]),
                 lambda: sorted_packed(keys),
                 lambda: bucketize_packed(keys),
                 lambda: chunked_sort_words(words),
                 lambda: chunked_sort_words([]),
                 lambda: chunked_sort_packed(keys),
                 lambda: sorted_run(keys),
                 lambda: run_to_device(np.ones(2, np.int32), keys),
                 lambda: distributed_chunked_sort_lex(keys),
                 lambda: init_lm(cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: BucketedScheduler._order_by_length(
                     [Request(0, [1]), Request(1, [2])])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_fails_without_a_card_or_outside_a_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = _run([str(alone)], cwd=tmp_path, env_extra={"PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    if not torch.cuda.is_available():
        res = _run([str(ROOT / "chip_smoke.py")])
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


# names of repro.kernels that exist only for the TPU, each with the port's
# counterpart (a module attribute of repro_torch.kernels)
_TPU_ONLY = {
    # how Pallas lowers (compiled or interpreted); the port's kernels are
    # CUDA, and where the ops run is in execution_provenance
    "pallas_lowering": "ops.execution_provenance",
    "merge_adjacent_pallas": "merge_kernel.merge_adjacent_lex",
    "merge_adjacent_kv_pallas": "merge_kernel.merge_adjacent_lex",
    "merge_adjacent_lex_pallas": "merge_kernel.merge_adjacent_lex",
    "merge_runs_pallas": "runmerge_kernel.merge_runs_lex_kernel",
    "merge_runs_lex_pallas": "runmerge_kernel.merge_runs_lex_kernel",
}


def test_every_public_kernel_name_has_a_counterpart():
    """Every name ``repro.kernels`` exports is exported by
    ``repro_torch.kernels`` too, or is TPU-only and has the counterpart
    listed above."""
    import importlib

    from repro import kernels as ref
    from repro_torch import kernels as port
    for name in ref.__all__:
        if name in _TPU_ONLY:
            assert name not in port.__all__
            module, attr = _TPU_ONLY[name].split(".")
            mod = importlib.import_module(f"repro_torch.kernels.{module}")
            assert callable(getattr(mod, attr)), name
            continue
        assert name in port.__all__, name
        assert hasattr(port, name), name


# the reference modules of the mesh tier and the names of each that exist
# only for JAX (the mesh-API shims of repro.parallel.compat; the port's
# collectives are the ring shift, gathers and all_to_all over a group)
_MESH_MODULES = {
    "core.bitonic": (),
    "core.distributed": (),
    "runtime.chaos": (),
    "parallel.compat": ("AxisType", "mesh_from_devices", "set_mesh",
                        "get_abstract_mesh", "shard_map", "shard_map_norep"),
}


@pytest.mark.parametrize("module", sorted(_MESH_MODULES))
def test_mesh_modules_export_the_reference_names(module):
    import importlib
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    for name in ref.__all__:
        if name in _MESH_MODULES[module]:
            continue
        assert name in port.__all__ and hasattr(port, name), name


# the reference modules of the serving path and the names of each that wait
# for ROADMAP A13: the PartitionSpec helpers and the Mamba/hybrid pieces
_SERVING_MODULES = {
    "core.oets": (),
    "configs": (),
    "data": (),
    "data.bucketing": (),
    "data.loader": (),
    "data.synthetic": (),
    "parallel.sharding": ("spec_for",),
    "models": (),
    "models.config": (),
    "models.param": ("PLeaf", "finalize", "tree_specs"),
    "models.layers": (),
    "models.attention": (),
    "models.moe": (),
    "models.blocks": ("init_mamba_block", "mamba_block"),
    "models.model": ("hybrid_groups",),
    "serve": (),
    "serve.engine": (),
    "serve.scheduler": (),
    "launch.serve": (),
}


@pytest.mark.parametrize("module", sorted(_SERVING_MODULES))
def test_serving_modules_export_the_reference_names(module):
    import importlib
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    for name in ref.__all__:
        if name in _SERVING_MODULES[module]:
            continue
        assert name in port.__all__ and hasattr(port, name), name
