"""The PyTorch port's EIP-7594 runtime against the JAX package's: types,
the upgrade, the fork-version ladder, the domain helpers at the mainnet
width, custody and the sidecars' structural checks.

Values are built by the JAX package (its ``test_infra``) and carried to
the port by SSZ; every comparison is exact (tolerance 0: bytes, integers
and verdicts).  Held equal: both specs build on both presets; the roots
of ``DataColumnSidecar``, ``DataColumnIdentifier``, ``BeaconBlockBody``
and ``BeaconState`` on seeded values (minimal); ``upgrade_to_eip7594``
(only ``fork`` differs from the pre-state); ``compute_fork_version`` at
epochs 0-6 on the Altair, Capella, Deneb and EIP-7594 specs, under the
default config and with the five forks at epochs 1-5;
``reverse_bits``, ``coset_for_cell`` of all 128 cells and
``compute_cells`` of one seeded blob at the mainnet width;
``get_custody_columns`` (count 33 raising in both);
``verify_data_column_sidecar``.  The cells' proofs, batches, recovery and
``is_data_available`` are in ``tests/test_torch_eip7594_das.py``.
"""
from random import Random

import numpy as np
import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra.execution_payload import build_empty_execution_payload
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.config import loader
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_kzg import blob
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_torch_bellatrix import bls_on, carry, jroot, root

N_VALIDATORS = 64
FORK = "eip7594"
LADDER = {"ALTAIR_FORK_EPOCH": 1, "BELLATRIX_FORK_EPOCH": 2, "CAPELLA_FORK_EPOCH": 3,
          "DENEB_FORK_EPOCH": 4, "EIP7594_FORK_EPOCH": 5}


@pytest.fixture(scope="module")
def specs():
    """The JAX and port EIP-7594 specs (minimal); both packages on python
    BLS with verification off."""
    mesh_state.use_fallback()
    jax_backend = jax_bls.backend_name()
    jax_bls.use_py()
    bls.use_py()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    yield jax_build_spec(FORK, "minimal"), build_spec(FORK, "minimal")
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    getattr(jax_bls, f"use_{jax_backend}", jax_bls.use_py)()
    mesh_state.use_auto()


@pytest.fixture(scope="module")
def genesis(specs):
    """A JAX EIP-7594 genesis with real sync-committee aggregates, at slot 3."""
    jspec, _ = specs
    with bls_on():
        state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                     jspec.MAX_EFFECTIVE_BALANCE)
    jspec.process_slots(state, 3)
    return state


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
def test_presets_and_spec(preset):
    """The preset file both packages load, and the fork's constants."""
    assert "eip7594" in loader.FORKS
    assert loader.load_preset(preset)["FIELD_ELEMENTS_PER_CELL"] == 64
    jspec, spec = jax_build_spec(FORK, preset), build_spec(FORK, preset)
    assert spec.fork == "eip7594" and spec.previous_fork == "deneb"
    for key in ("FIELD_ELEMENTS_PER_CELL", "FIELD_ELEMENTS_PER_BLOB", "NUMBER_OF_COLUMNS",
                "BYTES_PER_CELL", "DATA_COLUMN_SIDECAR_SUBNET_COUNT", "CUSTODY_REQUIREMENT",
                "SAMPLES_PER_SLOT", "PRIMITIVE_ROOT_OF_UNITY", "MAX_BLOBS_PER_BLOCK"):
        assert int(getattr(spec, key)) == int(getattr(jspec, key)), key
    assert spec.cells_per_blob() == jspec.cells_per_blob() == 128
    assert spec.RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN == jspec.RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN
    assert bytes(spec.config.EIP7594_FORK_VERSION) == bytes(jspec.config.EIP7594_FORK_VERSION)
    assert int(spec.config.EIP7594_FORK_EPOCH) == int(jspec.config.EIP7594_FORK_EPOCH)


def seeded_values(jspec, genesis, seed):
    """{type name: a JAX value} with seeded fields."""
    rng = Random(seed)
    rb = lambda n: bytes(rng.randrange(256) for _ in range(n))  # noqa: E731
    payload = build_empty_execution_payload(jspec, genesis)
    payload.transactions.append(rb(53))
    payload.blob_gas_used = rng.randrange(2**64)
    body = jspec.BeaconBlockBody(execution_payload=payload, graffiti=rb(32))
    for _ in range(3):
        body.blob_kzg_commitments.append(rb(48))
    header = jspec.BeaconBlockHeader(slot=rng.randrange(2**40), proposer_index=rng.randrange(64),
                                     parent_root=rb(32), state_root=rb(32), body_root=rb(32))
    sidecar = jspec.DataColumnSidecar(
        index=rng.randrange(128), column=[rb(jspec.BYTES_PER_CELL) for _ in range(3)],
        kzg_commitments=[rb(48) for _ in range(3)], kzg_proofs=[rb(48) for _ in range(3)],
        signed_block_header=jspec.SignedBeaconBlockHeader(message=header, signature=rb(96)))
    state = genesis.copy()
    state.latest_execution_payload_header = jspec._payload_to_header(payload)
    state.next_withdrawal_index = rng.randrange(2**64)
    return {"DataColumnSidecar": sidecar,
            "DataColumnIdentifier": jspec.DataColumnIdentifier(block_root=rb(32),
                                                               index=rng.randrange(128)),
            "BeaconBlockBody": body, "BeaconState": state}


@pytest.mark.parametrize("name", ["DataColumnSidecar", "DataColumnIdentifier",
                                  "BeaconBlockBody", "BeaconState"])
def test_container_roots(specs, genesis, name):
    jspec, spec = specs
    value = seeded_values(jspec, genesis, 5)[name]
    got = carry(spec, value, name)
    assert root(got) == jroot(value)
    assert ssz.serialize(got) == jax_ssz.serialize(value)


def test_upgrade_to_eip7594(specs):
    """A Deneb state upgraded in both packages: byte-identical, and only
    ``fork`` differs from the pre-state."""
    jspec, spec = specs
    jd = jax_build_spec("deneb", "minimal")
    pd = build_spec("deneb", "minimal")
    pre = create_genesis_state(jd, [jd.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                               jd.MAX_EFFECTIVE_BALANCE)
    jd.process_slots(pre, jd.SLOTS_PER_EPOCH + 3)
    pre.latest_execution_payload_header.blob_gas_used = 393216
    pre.next_withdrawal_index = 23
    want = jspec.upgrade_to_eip7594(pre.copy())
    ppre = carry(pd, pre, "BeaconState")
    got = spec.upgrade_to_eip7594(ppre)
    assert ssz.serialize(got) == jax_ssz.serialize(want)
    assert root(got) == jroot(want)
    assert bytes(got.fork.previous_version) == bytes(spec.config.DENEB_FORK_VERSION)
    assert bytes(got.fork.current_version) == bytes(spec.config.EIP7594_FORK_VERSION)
    assert int(got.fork.epoch) == 1
    fields = type(got)._fields
    differ = [f for f in fields if root(getattr(got, f)) != root(getattr(ppre, f))]
    assert differ == ["fork"]


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("fork", ["altair", "capella", "deneb", "eip7594"])
def test_compute_fork_version(fork, ladder):
    overrides = LADDER if ladder else None
    jspec = jax_build_spec(fork, "minimal", overrides)
    spec = build_spec(fork, "minimal", overrides)
    got = [bytes(spec.compute_fork_version(e)) for e in range(7)]
    assert got == [bytes(jspec.compute_fork_version(e)) for e in range(7)]
    if ladder:
        names = ["GENESIS", "ALTAIR", "BELLATRIX", "CAPELLA", "DENEB",
                 "EIP7594" if fork == "eip7594" else "DENEB", "EIP7594" if fork == "eip7594"
                 else "DENEB"]
        assert got == [bytes(getattr(spec.config, f"{n}_FORK_VERSION")) for n in names]


@pytest.fixture(scope="module")
def mainnet_specs():
    return jax_build_spec(FORK, "mainnet"), build_spec(FORK, "mainnet")


def test_domain_helpers_at_mainnet_width(mainnet_specs):
    jspec, spec = mainnet_specs
    for n, order in ((0, 1), (1, 2), (5, 8), (77, 128), (4095, 4096), (1234, 8192)):
        assert spec.reverse_bits(n, order) == jspec.reverse_bits(n, order)
    with pytest.raises(AssertionError):
        spec.reverse_bits(1, 6)
    with pytest.raises(AssertionError):
        jspec.reverse_bits(1, 6)
    for cell_id in range(128):
        assert spec.coset_for_cell(cell_id) == jspec.coset_for_cell(cell_id)
    for bad in (spec, jspec):
        with pytest.raises(AssertionError):
            bad.coset_for_cell(128)
    assert spec.compute_roots_of_unity(64) == jspec.compute_roots_of_unity(64)
    b = blob(np.random.default_rng(7594), 4096)
    cells = spec.compute_cells(b)
    assert cells == jspec.compute_cells(b)
    assert len(cells) == 128 and all(len(c) == 64 for c in cells)
    assert spec.bytes_to_cell(spec.cell_to_bytes(cells[9])) == cells[9]


@pytest.mark.parametrize("count", [1, 4, 32, 33])
def test_get_custody_columns(mainnet_specs, count):
    jspec, spec = mainnet_specs
    rng = Random(count)
    nodes = [0, 2**256 - 1] + [rng.randrange(2**256) for _ in range(3)]
    for node in nodes:
        if count > 32:
            with pytest.raises(AssertionError):
                spec.get_custody_columns(node, count)
            with pytest.raises(AssertionError):
                jspec.get_custody_columns(node, count)
            continue
        got = spec.get_custody_columns(node, count)
        assert [int(c) for c in got] == [int(c) for c in jspec.get_custody_columns(node, count)]
        assert len(got) == 4 * count and got == sorted(set(got))


@pytest.mark.parametrize("case", ["valid", "index", "empty", "commitments", "proofs"])
def test_verify_data_column_sidecar(specs, case):
    """The structural checks: an index past the columns, an empty column,
    a commitment or a proof too few."""
    jspec, spec = specs
    rng = Random(11)
    rb = lambda n: bytes(rng.randrange(256) for _ in range(n))  # noqa: E731
    cells = 0 if case == "empty" else 2
    sidecar = jspec.DataColumnSidecar(
        index=128 if case == "index" else 127,
        column=[rb(jspec.BYTES_PER_CELL) for _ in range(cells)],
        kzg_commitments=[rb(48) for _ in range(cells - (case == "commitments"))],
        kzg_proofs=[rb(48) for _ in range(cells - (case == "proofs"))])
    want = jspec.verify_data_column_sidecar(sidecar)
    assert spec.verify_data_column_sidecar(carry(spec, sidecar, "DataColumnSidecar")) is want
    assert want is (case == "valid")
