"""The PyTorch port's phase0 ``state_transition`` against the JAX
package's, minimal preset, 64 validators.

Genesis and blocks with attestations are built by the JAX package's
``test_infra`` and carried over by SSZ.  Over a run of slots that crosses
three epoch boundaries, the port (once with its vectorized epoch engine on
the plain versions, ``epoch_kernels.use_vectorized("cpu")``, and once
with its spec loops) and the JAX package's vectorized epoch engine end
every block at identical post-state roots (tolerance 0: bytes).  Both run
with ``bls_active`` off there: signatures
do not change the post-state.  The port then verifies signatures on its
torch backend (``bls.use_torch("cpu")``: the plain K1-K6) in exactly two
transitions: a valid block flushes as one product pairing, and a block
with one attestation's signature replaced raises with ``last_results``
naming that item alone.  A wrong ``state_root`` raises in both packages.
"""
import pytest

from consensus_specs_tpu.forks import build_spec as jax_build_spec
from consensus_specs_tpu.parallel import mesh_state
from consensus_specs_tpu.test_infra import attestations as jax_att
from consensus_specs_tpu.test_infra import block as jax_block
from consensus_specs_tpu.test_infra.genesis import create_genesis_state
from consensus_specs_tpu.utils import bls as jax_bls
from consensus_specs_tpu.utils import ssz as jax_ssz
from consensus_specs_tpu_torch.forks import build_spec
from consensus_specs_tpu_torch.ops import epoch_kernels
from consensus_specs_tpu_torch.utils import bls, ssz
from tests._torch_port import one_torch_thread  # noqa: F401

N_VALIDATORS = 64
SLOTS = 25          # slots 1..25: the epoch boundaries after slots 7, 15, 23


@pytest.fixture(scope="module")
def specs():
    mesh_state.use_fallback()
    jax_active, port_active = jax_bls.bls_active, bls.bls_active
    jax_bls.bls_active = bls.bls_active = False
    jspec = jax_build_spec("phase0", "minimal")
    yield jspec, build_spec("phase0", "minimal")
    jax_bls.bls_active, bls.bls_active = jax_active, port_active
    bls.use_py()
    mesh_state.use_auto()


def build_block(jspec, state, signed: bool, forge: bool = False):
    """A block for the next slot carrying an attestation of every committee
    of the slot before it, built on a copy of the JAX ``state``; returns
    (signed block, JAX post-state).  With ``signed``, the randao reveal,
    the attestations and the block carry real signatures (the JAX
    transition that fixes the state root still skips verification);
    ``forge`` gives attestation 1 the signature of attestation 0."""
    jax_bls.bls_active = signed
    post = state.copy()
    block = jax_block.build_empty_block_for_next_slot(jspec, post)
    if post.slot >= 1:
        slot = post.slot
        for index in range(jspec.get_committee_count_per_slot(
                post, jspec.compute_epoch_at_slot(slot))):
            block.body.attestations.append(jax_att.get_valid_attestation(
                jspec, post, slot, index=index, signed=signed))
    if forge:
        atts = block.body.attestations
        atts[1].signature = atts[0].signature
    jax_bls.bls_active = False
    jax_block.transition_unsigned_block(jspec, post, block)
    block.state_root = jax_ssz.hash_tree_root(post)
    jax_bls.bls_active = signed
    signed_block = jax_block.sign_block(jspec, post, block, block.proposer_index)
    jax_bls.bls_active = False
    return signed_block, post


def carry(spec, jax_value, name):
    return ssz.deserialize(getattr(spec, name), jax_ssz.serialize(jax_value))


@pytest.fixture(scope="module")
def chain(specs):
    """The JAX genesis and its run of SLOTS blocks: [(block, post-state)]."""
    jspec, _ = specs
    state = create_genesis_state(jspec, [jspec.MAX_EFFECTIVE_BALANCE] * N_VALIDATORS,
                                 jspec.MAX_EFFECTIVE_BALANCE)
    out = [(None, state)]
    for _ in range(SLOTS):
        out.append(build_block(jspec, out[-1][1], signed=False))
    return out


@pytest.mark.parametrize("engine", ["vectorized", "loops"])
def test_roots_match_across_epoch_boundaries(specs, chain, engine):
    jspec, spec = specs
    if engine == "vectorized":
        epoch_kernels.use_vectorized("cpu")
    else:
        epoch_kernels.use_loops()
    epoch_kernels.reset_stats()
    state = carry(spec, chain[0][1], "BeaconState")
    assert bytes(ssz.hash_tree_root(state)) == bytes(jax_ssz.hash_tree_root(chain[0][1]))
    n_att = 0
    try:
        for signed_block, jax_post in chain[1:]:
            block = carry(spec, signed_block, "SignedBeaconBlock")
            n_att += len(block.message.body.attestations)
            spec.state_transition(state, block)
            assert bytes(ssz.hash_tree_root(state)) == bytes(jax_ssz.hash_tree_root(jax_post))
            assert ssz.serialize(state) == jax_ssz.serialize(jax_post)
        stats = epoch_kernels.stats()
    finally:
        epoch_kernels.use_auto()
    # three boundaries x four sub-transitions; the first boundary's
    # rewards are the genesis no-op, which the spec body handles
    if engine == "vectorized":
        assert stats == {"vectorized": 11, "loop": 1, "guard": 0}
    else:
        assert stats == {"vectorized": 0, "loop": 12, "guard": 0}
    assert state.slot == SLOTS and n_att >= 2 * (SLOTS - 1)
    # the run reached rewards (second boundary) and justification (third)
    assert len(set(state.balances)) > 1
    assert state.current_justified_checkpoint.epoch == 2


def test_wrong_state_root_raises_in_both(specs, chain):
    jspec, spec = specs
    signed_block = chain[5][0].copy()
    signed_block.message.state_root = b"\x01" * 32
    jstate = chain[4][1].copy()
    with pytest.raises(AssertionError):
        jspec.state_transition(jstate, signed_block)
    state = carry(spec, chain[4][1], "BeaconState")
    with pytest.raises(AssertionError):
        spec.state_transition(state, carry(spec, signed_block, "SignedBeaconBlock"))


def test_signed_blocks_on_the_torch_backend(specs, chain):
    """The two transitions with BLS on: a valid block is one product
    pairing; a forged attestation signature is named alone."""
    jspec, spec = specs
    good, jax_post = build_block(jspec, chain[-1][1], signed=True)
    bad, _ = build_block(jspec, jax_post, signed=True, forge=True)
    n = len(bad.message.body.attestations)

    bls.use_torch("cpu")
    bls.bls_active = True
    try:
        state = carry(spec, chain[-1][1], "BeaconState")
        with bls.scoped_batch(bls.DeferredBatch()) as batch:
            spec.state_transition(state, carry(spec, good, "SignedBeaconBlock"))
        assert batch.pairings == 1
        # proposer signature, randao reveal, one item per attestation
        assert batch.last_results == [True] * (2 + len(good.message.body.attestations))
        assert bytes(ssz.hash_tree_root(state)) == bytes(jax_ssz.hash_tree_root(jax_post))

        with bls.scoped_batch(bls.DeferredBatch()) as batch:
            with pytest.raises(AssertionError, match=r"items \[3\]"):
                spec.state_transition(state, carry(spec, bad, "SignedBeaconBlock"))
        assert batch.pairings == 1 + 2 + n
        assert [i for i, ok in enumerate(batch.last_results) if not ok] == [3]
    finally:
        bls.bls_active = False
        bls.use_py()
