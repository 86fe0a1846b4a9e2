"""The port's registry against the JAX package's: the same registry script
lowers to equal ``EngineTables``, array for array (dtypes included), and
the snapshot mirror round-trips between the two packages."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402


def _script(mod, variant):
    """One registry history: tenants, sources, composites with filters,
    cross-tenant subscriptions, rewires, revocations and sid recycling."""
    cfg = mod.EngineConfig(n_streams=40, n_tenants=3, channels=3, max_in=4,
                           max_out=5, batch=8, queue=64, prog_len=32,
                           n_consts=8, n_temps=8, fault_threshold=2,
                           fault_amp_ceiling=3)
    reg = (mod.Registry.with_capacity(cfg, max_streams=48, max_subs=6)
           if variant == "padded" else mod.Registry(cfg))
    ts = [reg.create_tenant(n) for n in ("a", "b", "c")]
    rng = np.random.default_rng(3)
    srcs = [reg.create_stream(ts[i % 3], f"s{i}", ["x", "y", "z"][: 1 + i % 3])
            for i in range(9)]
    comps = []
    for i in range(6):
        ins = [srcs[j] for j in rng.choice(9, 1 + i % 3, replace=False)]
        ch = ["x", "y"]
        tr = {"x": f"in0 * {i + 1}.5 - abs(in0)",
              "y": "max(in0, prev.y) + ts % 7" if i % 2 else "trigger"}
        comps.append(reg.create_composite(
            ts[(i + 1) % 3], f"c{i}", ch, ins, tr,
            pre_filter="in0 > -2" if i % 3 == 0 else None,
            post_filter="out.x != 0 && out.y < 1e6" if i % 3 == 1 else None))
    reg.subscribe(comps[0], srcs[8])
    reg.unsubscribe(comps[1], reg.streams[comps[1].inputs[0]])
    if variant != "plain":
        reg.remove_stream(srcs[2])
        reg.create_stream(ts[0], "recycled", ["x"])
    return reg


@pytest.mark.parametrize("variant", ["plain", "churned", "padded"])
def test_same_script_gives_equal_tables(variant):
    want = _script(J, variant).build_tables(
        np.arange(40 if variant != "padded" else 48, dtype=np.int32) % 3)
    got = _script(P, variant).build_tables(
        np.arange(40 if variant != "padded" else 48, dtype=np.int32) % 3)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32
                                      else a,
                                      b.view(np.int32) if b.dtype == np.float32
                                      else b, err_msg=f.name)


@pytest.mark.parametrize("variant", ["plain", "churned"])
def test_snapshot_mirror_crosses_packages(variant):
    """A JAX-package registry snapshot rebuilds in the port (and back)
    into a registry that lowers to the same tables."""
    j = _script(J, variant)
    p = P.Registry.from_snapshot(j.to_snapshot())
    assert p.to_snapshot() == j.to_snapshot()
    back = J.Registry.from_snapshot(p.to_snapshot())
    for f in dataclasses.fields(J.Registry(j.cfg).build_tables()):
        np.testing.assert_array_equal(getattr(back.build_tables(), f.name),
                                      getattr(p.build_tables(), f.name))
