"""``repro_torch.roofline.analysis`` against the JAX package's: the
collective records of each collective in ``tests/test_roofline.py``'s HLO
fixture give ``collective_bytes_from_hlo``'s numbers, ``roofline_terms``
equals the reference's given the same machine, ``model_flops``, and the HBM
model on an op log (the fixture of ``test_tpu_hbm_model`` as torch ops)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.roofline import analysis as jra  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis as tra  # noqa: E402

# each collective of the reference's HLO_FIXTURE, and its record
FIXTURE = [
    ("%ag = bf16[16,4096,512]{2,1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, "
     "dimensions={2}", {"kind": "all-gather", "bytes": 16 * 4096 * 512 * 2, "n": 4}),
    ("%ar = f32[1024,1024]{1,0} all-reduce(%x), replica_groups=[16,2]<=[32] to_apply=%add",
     {"kind": "all-reduce", "bytes": 1024 * 1024 * 4, "n": 2}),
    ("%rs = f32[64,128]{1,0} reduce-scatter(%y), replica_groups={{0,1}}, dimensions={0}",
     {"kind": "reduce-scatter", "bytes": 64 * 128 * 4, "n": 2}),
    ("%cp = bf16[256]{0} collective-permute(%z), source_target_pairs={{0,1}}",
     {"kind": "collective-permute", "bytes": 256 * 2, "n": 2}),
    ("%a2a = s32[8,8]{1,0} all-to-all(%w), replica_groups={{0,1,2,3,4,5,6,7}}",
     {"kind": "all-to-all", "bytes": 8 * 8 * 4, "n": 8}),
]


@pytest.mark.parametrize("line,record", FIXTURE, ids=[r["kind"] for _, r in FIXTURE])
def test_each_collective_equals_the_reference_parser(line, record):
    want = jra.collective_bytes_from_hlo(line)
    got = tra.collective_bytes([record])
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert np.isclose(got[key], value), key


def test_all_collectives_together_and_none():
    text = "\n".join(line for line, _ in FIXTURE)
    want = jra.collective_bytes_from_hlo(text)
    got = tra.collective_bytes([r for _, r in FIXTURE])
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert np.isclose(got[key], value), key
    assert tra.collective_bytes([]) == {"wire_bytes_total": 0.0}
    with pytest.raises(ValueError):
        tra.wire_bytes("broadcast", 8, 2)


@pytest.mark.parametrize("flops,nbytes,wire", [(197e12, 819e9, 50e9), (197e12, 8.19e9, 5e9),
                                               (1e12, 819e9, 50e9), (0.0, 0.0, 0.0)])
def test_roofline_terms_equal_the_reference_on_one_machine(flops, nbytes, wire):
    hw = tra._HW(peak_flops_bf16=jra.HW.peak_flops_bf16, hbm_bw=jra.HW.hbm_bw,
                 link_bw=jra.HW.ici_bw, hbm_bytes=jra.HW.hbm_bytes)
    assert tra.roofline_terms(flops, nbytes, wire, hw) == jra.roofline_terms(flops, nbytes, wire)


def test_the_port_counts_in_h100_terms():
    assert tra.HW.peak_flops_bf16 == 989e12 and tra.HW.hbm_bw == 3.35e12
    assert tra.HW.link_bw == 450e9 and tra.HW.hbm_bytes == 80e9
    fields = {f.name for f in dataclasses.fields(tra._HW)}
    assert "ici_bw" not in fields
    t = tra.roofline_terms(989e12, 3.35e12, 450e9)
    assert np.isclose(t["compute_s"], 1.0) and np.isclose(t["memory_s"], 1.0)
    assert np.isclose(t["collective_s"], 1.0)


def test_model_flops():
    assert tra.model_flops(10, 10, 100, "train") == jra.model_flops(10, 10, 100, "train")
    assert tra.model_flops(10, 4, 100, "prefill") == 2 * 4 * 100


def test_hbm_model_counts_params_products_and_collectives_not_elementwise():
    """The reference's ``test_tpu_hbm_model`` program as torch ops: a bf16
    product, a convert and a broadcast; only the parameters and the
    product's operands and output count."""
    p0 = torch.empty((1024, 1024), dtype=torch.bfloat16, device="meta")
    p1 = torch.empty((1024, 512), dtype=torch.bfloat16, device="meta")

    def program():
        d = p0 @ p1
        c = d.float()
        return c * 2.0

    got = dryrun.measure(program)
    params = p0.nbytes + p1.nbytes
    hbm = tra.hbm_bytes_from_ops(got["ops"], params)
    d = 1024 * 512 * 2
    assert hbm == params + d + (p0.nbytes + p1.nbytes)
    assert got["flops"] == 2 * 1024 * 1024 * 512
    # raw bytes count the elementwise ops too
    assert got["bytes"] > hbm - params
