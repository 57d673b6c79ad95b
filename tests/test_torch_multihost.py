"""The port's meshed Model and multi-process helpers
(slimt_tpu_torch/parallel/multihost.py) on [cpu] * n meshes, against the
single-device port and the JAX package's Model on its conftest mesh:
Model(mesh=...) through the port's Blocking gives the same texts (DP x TP,
replicated, SP), the seq axis must divide the T bucket, and the small
functions (shard_lines, initialize, global_mesh, scaling_report) behave as
the JAX package's.
"""

import pytest

torch = pytest.importorskip("torch")

from slimt_tpu.config import Config as JaxConfig  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.parallel import multihost as jmultihost  # noqa: E402
from slimt_tpu.parallel.sharding import make_mesh as jax_mesh  # noqa: E402
from slimt_tpu.runtime.service import Blocking as JaxBlocking  # noqa: E402
from slimt_tpu_torch import Blocking, Config, Model, Package  # noqa: E402
from slimt_tpu_torch.parallel import multihost  # noqa: E402
from slimt_tpu_torch.parallel.sharding import make_mesh  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

SOURCES = ["hello world", "goodbye test", "quick brown fox jumps"]
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def packages():
    jax_pkg = make_package()
    port_pkg = Package(jax_pkg.model, jax_pkg.vocabulary, jax_pkg.shortlist, jax_pkg.ssplit)
    return jax_pkg, port_pkg


@pytest.fixture(scope="module")
def want(packages):
    """The single-device port's texts, checked against the JAX Model's."""
    jax_pkg, port_pkg = packages
    jax_texts = [r.target.text for r in JaxBlocking(JaxConfig(cache_size=0)).translate(
        JaxModel(TINY_TEST_CONFIG, jax_pkg), SOURCES)]
    with Blocking(Config(cache_size=0)) as service:
        texts = [r.target.text for r in service.translate(
            Model(TINY_TEST_CONFIG, port_pkg, device="cpu"), SOURCES)]
    assert texts == jax_texts
    return texts


@pytest.mark.parametrize("layout,sharding,sequence", [
    ((4, 2, 1), "tp", False),
    ((8, 1, 1), "replicate", False),
    ((2, 1, 4), "replicate", True),
    ((2, 2, 2), "tp", True),
], ids=["dp-tp", "replicated", "dp-sp", "dp-tp-sp"])
def test_model_on_mesh_matches_single_device_and_jax(packages, want, layout, sharding,
                                                     sequence):
    _, port_pkg = packages
    model = Model(TINY_TEST_CONFIG, port_pkg, mesh=make_mesh(*layout, devices=CPU8),
                  sharding=sharding, shard_sequence=sequence)
    assert model._data_size == layout[0]
    with Blocking(Config(cache_size=0)) as service:
        got = [r.target.text for r in service.translate(model, SOURCES)]
    assert got == want


def test_model_on_mesh_matches_the_jax_mesh_model(packages):
    """The JAX Model on its conftest (4, 2) mesh and the port's on [cpu] * 8
    serve the same texts."""
    jax_pkg, port_pkg = packages
    jax_model = JaxModel(TINY_TEST_CONFIG, jax_pkg, mesh=jax_mesh(data=4, model=2))
    jax_texts = [r.target.text for r in JaxBlocking(JaxConfig(cache_size=0)).translate(
        jax_model, SOURCES)]
    port = Model(TINY_TEST_CONFIG, port_pkg, mesh=make_mesh(4, 2, devices=CPU8))
    with Blocking(Config(cache_size=0)) as service:
        assert [r.target.text for r in service.translate(port, SOURCES)] == jax_texts


def test_model_mesh_checks(packages):
    _, port_pkg = packages
    with pytest.raises(ValueError, match="seq axis"):
        Model(TINY_TEST_CONFIG, port_pkg, mesh=make_mesh(seq=5, devices=CPU8),
              shard_sequence=True)
    with pytest.raises(ValueError, match="sharding"):
        Model(TINY_TEST_CONFIG, port_pkg, mesh=make_mesh(devices=CPU8), sharding="zero")


def test_shard_lines_equal_jax():
    lines = [f"l{i}" for i in range(10)]
    for count in (1, 3, 4):
        parts = [multihost.shard_lines(lines, p, count) for p in range(count)]
        assert parts == [jmultihost.shard_lines(lines, p, count) for p in range(count)]
        assert sorted(sum(parts, [])) == sorted(lines)


def test_initialize_single_process_noop():
    import torch.distributed as dist

    multihost.initialize(num_processes=1)  # must not raise
    assert not dist.is_initialized()


def test_global_mesh_over_local_devices():
    mesh = multihost.global_mesh(model=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "model": 2, "seq": 1}
    assert mesh.process_count == 1


def test_scaling_report_harness(packages):
    _, port_pkg = packages

    def make_model(mesh):
        return Model(TINY_TEST_CONFIG, port_pkg, mesh=mesh, sharding="replicate")

    report = multihost.scaling_report(
        make_model, lambda: Blocking(Config(cache_size=0)), ["hello world"] * 4,
        device_counts=[1, 2], devices=CPU8)
    assert set(report["throughput"]) == {1, 2}
    assert report["efficiency"][1] == pytest.approx(1.0)


def test_dryrun_multichip_on_the_cpu():
    """slimt_tpu_torch.entry.dryrun_multichip over [cpu] * 4 (the blockwise
    SP leg at T=64): every leg's tokens equal one device's."""
    from slimt_tpu_torch import entry

    report = entry.dryrun_multichip(4, devices=["cpu"], long_t=64)
    assert [leg["leg"] for leg in report] == list(entry.LEG_KERNELS)
    assert all(leg["equal"] and leg["tokens"] for leg in report)
