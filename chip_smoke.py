#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, verify a
mainnet-shaped block, run a block's blobs through the KZG library and
PeerDAS recovery, run a mainnet phase0 block through
``state_transition``, run a mainnet phase0 epoch transition, run a
mainnet Altair block and an Altair epoch transition, run a mainnet
Capella block (withdrawals and BLS-to-execution changes) and a Capella
epoch transition, run a mainnet Deneb block whose six-blob KZG batch
joins the block's one product pairing and a Deneb epoch transition under
the activation churn cap, run a mainnet EIP-7594 block whose six blobs
are sampled by cell, each blob's cell batch joining the block's one
product pairing (the epochs and the cold and post-epoch roots through
the mesh engine), time.

    python3 chip_smoke.py [--validators N]
    python3 chip_smoke.py --probe [--root DIR] [--only K1,K18,...] [--sweep RUNS]

``--probe`` runs no phase: it times K1, K3 and K2 at every batch size
the block paths launch them with (K1 with scalars and without), K18 at
2^14, 2^16, 2^18 and 2^20 leaves (and at every CTA size where the tree
takes one), K7 at every shape of the blob and
sampling paths, K4 at the block flush's, the per-lane batch's and the
blob and cell verifies' shapes, K8 at the path's three shapes (with its
stages), K15 at the epoch engine's max-only and rewards calls beside
``torch.amax`` and an empty launch, K9 per whole transform at (6, 8192)
(the recovery's batches, with every cluster size), (6, 16), (6, 64) and
(6, 4096), forward and inverse (a tree before K9's one launch a batch:
its stage launches), K17 at 2^20 lanes over 1, 2 and 4 spans beside
``torch.nonzero`` (``--only k9,k17``), K10-K14 and K16 at 2^20 lanes
(``epoch``: K13 leaking and not, K16's fill alone, its scatter and its
entries in lane order), K5 and K6 (``sha``: K6 at 256, 4,224 and 67,584
messages of 1, 5 and 17 blocks, and the round-latency probe's ns per
round with K5's and K6's chain floors in ms), and EIP-7594 at full
width (``eip7594``: one blob's 128 cell proofs through
``compute_cells_and_proofs``, split into host polynomial work and
``g1_lincomb``; ``recover_cells_and_kzg_proofs`` from a seeded half; the
128 sidecars of a one-blob block through
``verify_data_column_sidecar_kzg_proofs``; ``upgrade_to_eip7594`` of a
2^20-validator Deneb state and its cold root), through the wrappers
alone, so that it measures any tree of the port: ``--root`` names a checkout of it
inside this one (an unpacked parent commit; default: this checkout).
With ``--sweep RUNS`` it then times the columnar engine against the mesh
engine at 2^12, 2^14 and 2^16 validators on both forks, the least of
RUNS runs each, every run's root equal.  Its last line is one JSON
object of what it measured.

Phases, each fatal on failure (no phase's failure is caught):

1. print the card (name and power limit), build the CUDA kernels from
   ``consensus_specs_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel (K1-K4) byte-identical to its plain PyTorch version
   on the card and to the python oracle, on small seeded inputs;
3. verify a mainnet-shaped block through the port's entry points: 128
   FastAggregateVerify aggregates of 512 distinct keys, a 512-key sync
   aggregate, the proposer signature and the randao reveal (131 items,
   66,050 pubkeys aggregated on the card) - ``DeferredBatch.flush`` on
   the torch backend (one product pairing), the per-lane batch verify, a
   bad signature named by ``last_results``, and AggregateVerify over 16
   messages;
4. hold K1, K3 and K2 against their plain versions and the oracle on
   edge inputs (K1: rows of 0, 1 and 90 keys, P and -P, a repeated key,
   keys cancelling across teams, with the scalars 0, 1, 2^128 - 1, a
   single set bit, long runs of ones and of zeros, and none; K3: u = 0, a
   real u, u's whose maps take x1 and x2 in either half; K2: an
   all-infinity batch, lanes P and -P, zero scalars and a repeated
   signature, one lane), then each kernel byte-identical to its
   plain version again at every shape the block gave it (the flush's and
   the per-lane batch's calls; K4's GT values too, and on the flush with
   one pair's P negated), then time each kernel at the flush's shapes
   (CUDA events, after one warm-up; K1 also at the per-lane batch's)
   beside its plain version, its bound and (K1-K3) its chain floor, and
   time the block flush and the 128-lane batch;
5. hold K5 ``hash64`` and K6 ``sha256_blocks`` byte-identical to their
   plain versions on the card and to hashlib, on seeded rows (n = 1, 3,
   255, 256, 257, 4096) and K6 at m = 1, 31, 33, 256 and 257 messages of
   1, 2, 5 and 17 blocks, on words that start on 16 bytes and one word
   off; measure the round-latency probe's ns per round
   (``sha256.sha256_chain``, held against its plain version), which turns
   K5's and K6's chain floors into ms;
6. (run right after phase 9) a mainnet phase0 block through the port's
   ``state_transition`` on the card (``build_spec("phase0", "mainnet")``, ``bls.use_torch()``,
   ``sha256.install_merkle_hasher()``): a ``BeaconState`` of 2^20 active
   validators (``--validators``), a block at slot 3 with 128
   attestations (the 64 committees of slots 1 and 2, every bit set, each
   signed with the sum of its members' secret keys), the proposer
   signature and the randao reveal - 130 RLC items, 65,538 keys.  The
   pre-state's cold root on K5 must equal the hashlib root of a fresh
   deserialization; the block must pass ``state_transition`` with one
   product pairing; the post-state's hashlib root must equal the block's
   ``state_root``; a forged attestation signature must be named alone;
   a wrong ``state_root`` must raise.  Every K1-K4 call of the transition
   is held against its plain version (K4's GT values too); every K5
   launch of the transition, the cold root's largest launch and one
   launch per tree level are held against the plain version; the cold
   root's tree builds of 2^14 chunks or more go through the mesh
   engine's span build (K18 launched, every call held against its plain
   version); set-up, the cold root (K5
   and K18 against hashlib), the transition's stages, K5 per launch and
   the copies are timed;
7. (run right after phase 15, so that phase 19 finds phase 8's blobs)
   hold K7 ``expand_windows``, K8 ``g1_msm`` and K9 ``fr_fft``
   byte-identical to their plain versions on the card and to the oracle
   (MSMs at N = 1, 3, 8, 300 with the scalars 0, 1, r - 1, a repeated
   base, P beside -P and the point at infinity; K8 also on skewed digits:
   every scalar one repeated byte, all 32 N lanes in one bucket, and a
   single live lane at N = 1024, every other point at infinity at N =
   4096; K7 also at N = 5, 6, 33, a partial warp of teams; FFTs at n = 2,
   256, 8192 forward, inverse and round trip against the host
   ``fft_field``; K9 at every n from 2 to 2^14 with 1 to 7 rows and at
   2^17 and 2^18 points, forward and inverse);
8. a block's blobs through the port's KZG library on the card
   (``bls.use_torch()``, the real trusted setup): six blobs of 4096
   seeded field elements, a commitment and a proof each (12 MSMs of 4096
   points on K7/K8), ``verify_blob_kzg_proof_batch`` with one K4 launch,
   the batch with one element changed rejected, blob 0's commitment and
   proof equal to the oracle's Pippenger, the first K7 and K4 call of
   every shape held against its plain version (K4's GT values too, and on
   the call with one pair's P negated), every K8 call held as in phase 9;
   commit, prove and verify timed;
9. PeerDAS: the six blobs' cells, ``recover_cells_batch`` from the same
   64 of 128 columns of every blob (one group: 4 batched FFTs of (6, 8192)
   on K9, one launch each, counted against the batches, every launch held
   against the plain version) equal to the
   original cells; cell proofs for 8 columns x 6 blobs (MSMs of 4032
   monomial points on K8) verified by ``verify_cell_proof_batch`` with
   one K4 launch, a changed cell rejected; every K8 call of the sampling
   held against its plain version (the first on each window table
   replayed, all of them through one seeded weighted sum per table);
   recovery and verify timed;
10. a mainnet phase0 epoch transition through the port's
   ``process_slots`` with the epoch engine on the card
   (``epoch_kernels.use_vectorized()``): K10 ``phase0_deltas``, K11
   ``effective_balance`` and K12 ``slashings`` held byte-identical to
   their plain versions on seeded edge columns (K12 also at n = 1, 3, 4,
   5, 7, 1000 and 2^20 + 3 with increments 1, a power of two and a prime,
   the total at the increment, adjusted 0 and at the total, no targets,
   all and every fourth, products at the guard's limit, on columns that
   start on their storage and one lane into it); a ``BeaconState`` of 2^20
   validators (``--validators``) at slot 223 with the registry edges of
   ``tests/test_epoch_vectorized.py`` scattered and the 2048 committees
   of epoch 5 in ``previous_epoch_attestations`` (all bits set; no
   signatures: epoch processing checks none), run once at epoch 0 (an
   inactivity leak) and, on a registry of 2^18 built the same way
   (``QUIET_VALIDATORS``, a depth cut for the time limit), once finalized
   at epoch 4.  Each run commits 4
   sub-transitions on the mesh engine (``parallel/mesh_epoch.py``) with
   no decline, no loop run and no guard trip; launches K10-K12 once,
   K15 ``epoch_reduce`` 3 times, K16 ``incl_scan`` once, K17
   ``registry_scan`` once and K18 ``merkle_levels`` in the balances'
   commit (the exact span builds and launches); makes every mask on the
   card, so its crossings are restated: balances and effective balances
   once each way, the registry's epoch columns up once, the registry
   updates' written lanes up in one copy (scattered into the card
   copies), the attester masks and inclusion entries up once and the
   inclusion keys down once; ends at the hashlib root of a fresh
   deserialization, and every K10-K12 and K15-K18 call is held against
   its plain version; at 4,096 validators the spec loops, the columnar
   engine and the mesh engine give identical roots, leaking and not.
   Stages, copies and K10-K12 per launch (CUDA events, beside bounds and
   plain versions) are timed;
11. time K10-K12 per launch at the leaking run's arguments (CUDA events,
   queued ahead and back to back) beside their bounds and plain versions;
12. hold K13 ``altair_deltas`` and K14 ``inactivity_updates``
   byte-identical to their plain versions on the card at 1, 1000 and 2^20
   lanes, leaking and not, on seeded edge columns (every flag
   combination, eligible and not, active and not, zero balances, clamps
   at the first, a middle and the last of K13's four pairs, scores 0, 1
   and the recovery rate, lane products just under 2^63), and K13 at n =
   1, 3, 4, 5, 7, 1000 and 2^20 + 3 with every divisor 1, powers of two
   and primes, products at the guards' limit, on columns that start on
   their storage and one lane into it;
13. (run right after phase 6, so that its 2^20-validator state is not
   held through phases 7-12) a mainnet Altair block through the port's
   ``state_transition`` on the card (``build_spec("altair", "mainnet")``):
   phase 6's 2^20-validator state through ``upgrade_to_altair``, a block at slot 3 with the 128
   attestations of phase 6's shape (participation flags and the proposer
   reward), the current sync committee's aggregate with a seeded ~1/16 of
   its 512 bits off, the proposer signature and the randao reveal - 131
   RLC items.  It must pass with one product pairing, the post-state's
   hashlib root must equal the block's ``state_root`` and a forged
   sync-aggregate signature must be named alone (phase 6 holds the
   wrong-``state_root`` rejection); every K1-K4 call at a shape phase 4 did not
   hold and the first K5 call of every row count are held against their
   plain versions, and so is
   every K18 call of the upgrade and its cold root (the new inactivity
   and participation lists go through the span build); the upgrade,
   ``process_attestation``, ``process_sync_aggregate`` and the flush are
   timed;
14. a mainnet Altair epoch transition: phase 10's not-leaking registry
   of 2^18 (a depth cut) through ``upgrade_to_altair``
   (``translate_participation`` turns its pending attestations into the
   previous epoch's flags), seeded inactivity scores (some at the scale
   of a long leak) and current-epoch flags, run through ``process_slots``
   once leaking and once not; phase 10's untouched 2^20 base is upgraded
   the same way and hashed for phase 20.
   Each run launches K14, K13, K11 and K12 once, commits 5
   sub-transitions on the engine with no loop run and no guard trip,
   moves balances, effective balances and inactivity scores once each
   way and the previous flags up once, ends at the hashlib root of a
   fresh deserialization, and every kernel call is held against its
   plain version; at 4,096 validators the spec loops, the columnar
   engine and the mesh engine give identical roots, leaking and not; K13
   and K14 are timed per launch.  As in phase 10 the run goes through the
   mesh engine: 5 commits, K15 4 times, K16 not at all, K17 once, K18 in
   the commits, no mask crossing;
15. (run right after phase 5) hold K15 ``epoch_reduce`` and K16
   ``incl_scan`` byte-identical to their plain versions on the card at 1,
   1000 and 2^20 lanes with S = 1 and 4 spans (K15 in each of the epoch
   engine's five calls, its dispatch set, and a call outside it refused;
   span starts off a 16-byte boundary; FAR epochs, sums past 2^63, maxima
   at 2^64 - 1, every flag combination, duplicate and pad inclusion
   entries with keys up to the sentinel; K16 also at odd lane counts with
   m = 0, 1, 2, 3, 5 and three entries a lane, pads, negative and
   out-of-range indices, keys >= 2^63 and the sentinel, and idx and keys
   one entry into their storage), K17 ``registry_scan`` at S = 1,
   2 and 4 spans of 1, 1000, 2048 (a tile) and 2049 lanes and at 2^20
   lanes (a count above the cap, every lane a candidate, with and without
   fill), and K18
   ``merkle_levels`` to its plain version and every level to hashlib on
   leaf layers of 2^14 - 1, 2^14, 2^14 + 1, 3 x 2^13 + 5 and 2^20 chunks
   with S = 1 and 4, at every width from 2^14 to 2^20 leaves with S = 1, 2
   and 4 (the wrapper's plans), and every level to hashlib at depths 1 to
   14 with S = 1, 2 and 4 and CTAs of 32 to 512 threads (one to four
   tiers),
   ``build_levels`` to the sequential build and a span-built tree
   updated incrementally to a fresh build;
16. time K15-K18 per launch (K18: per tree, one launch) at the main
   path's calls (CUDA events, queued ahead) beside their bounds (K18 also
   its chain floor), plain versions and, where one
   PyTorch call computes the same function, that call, and an empty
   launch (K16 also its fill alone; K10-K14 also at the not-leaking
   run's call); print the ``kernels`` line (K1-K18, every number measured in
   this run but the bounds; K8 with its per-stage times at the
   commitment, cell and verify shapes; K7 at every launched shape and K4
   at every path's shape, each with its launches), the card line and the
   result line;
17. (run right after phase 13) a mainnet Capella block through the
   port's ``state_transition`` on the card (``build_spec("capella",
   "mainnet")``): phase 13's 2^20-validator pre-state through
   ``upgrade_to_bellatrix`` (with a non-empty payload header: the chain
   went through the merge) and ``upgrade_to_capella``, 16 partial
   withdrawals seeded within the sweep's first 16,384 lanes (``0x01``
   credentials, 32 ETH effective, balance above it) before the cold root,
   and a block at slot 3 with phase 13's attestations and sync aggregate
   signed under the Capella fork version, a payload whose withdrawals are
   ``get_expected_withdrawals``, 16 ``SignedBLSToExecutionChange``s of
   validators whose ``0x00`` credentials come from their own registry
   keys (signed under ``DOMAIN_BLS_TO_EXECUTION_CHANGE``), the proposer
   signature and the randao reveal - 147 RLC items.  It must pass with
   one product pairing, the post-state's hashlib root must equal the
   block's ``state_root``, the withdrawal cursors must advance as the
   spec says and the changes apply and a forged BLS-change signature must
   be named alone (phase 6 holds the wrong-root rejection); the K1-K5 and K18
   calls are held as in phase 13, and K1-K4 timed at the flush's shapes
   (per call queued ahead); the upgrades, ``process_withdrawals``,
   the flush, the changes' share of the flush (the block's items with and
   without them, in turns) and the transition are timed;
18. (run right after phase 14) a mainnet Capella epoch transition:
   phase 14's not-leaking Altair registry of 2^18 (a depth cut; the 2^20
   base goes to phase 20) through the two upgrades, run once through
   ``process_slots`` leaking (its slashed validators' penalties due,
   ``slashings`` at which multipliers 3 and 2 differ) on the mesh engine
   as phase 14 runs (K14, K13, K11, K12 once each, K15 4 times, K17 once,
   K18 in the commits, every call held), ending at the hashlib root of a
   fresh deserialization; K13's recorded inactivity scalar must be
   ``INACTIVITY_SCORE_BIAS * INACTIVITY_PENALTY_QUOTIENT_BELLATRIX`` and
   K12's adjusted total Bellatrix's multiplier 3 of ``slashings``; K13 and
   K12 are timed per launch; at 4,096 validators the spec loops, the
   columnar engine and the mesh engine give identical roots, leaking and
   not;
19. (run right after phase 17, on its pre-state) a mainnet Deneb block
   through the port's ``state_transition`` on the card
   (``build_spec("deneb", "mainnet")``): phase 17's 2^20-validator
   Capella pre-state through ``upgrade_to_deneb``, a block at slot 3 with
   phase 17's content (128 attestations and the sync aggregate signed
   under the Deneb fork version, its 16 withdrawals, 16 BLS-to-execution
   changes on lanes phase 17 did not change), phase 8's six blob
   commitments (``MAX_BLOBS_PER_BLOCK``) and a payload with their blob gas
   and their blob transaction.  One batch scope holds
   ``is_data_available`` (``retrieve_blobs_and_proofs`` hands back phase
   8's blobs and proofs) and ``state_transition``, as Deneb's ``on_block``
   composes them: the KZG batch defers its two pairs, and the block's
   147 RLC items and the deferred check pass as one product pairing, one
   K4 launch of one group of 150 pairs.  The post-state's hashlib root
   must equal the block's ``state_root``; a recording execution engine
   must see the six versioned hashes ``0x01 || sha256(commitment)[1:]``
   and the parent root; with one blob's proof replaced by another's, the
   flush of the block's items and the deferred check must fail with
   ``last_results`` all True and ``last_pairing_results == [False]``.
   Every K1-K5, K7 and K8 call at a shape no earlier phase held and every
   K18 call of the upgrade and its cold root are held against their plain
   versions (K4's GT values too); ``is_data_available``, the flush and K4
   at the new group size are timed;
20. (run right after phase 18) a mainnet Deneb epoch transition: phase
   14's 2^20 Altair base through the three upgrades, 32 deposits queued
   for activation (eligible since epoch 0: the churn limit stays 16), run
   once through ``process_slots`` leaking on the mesh engine as phase 18
   runs: exactly the first 8 queued lanes are activated (EIP-7514's
   ``MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT``; Capella's rule would take
   16), the engine commits with no decline, no loop and no guard trip,
   K13 and K12 take Bellatrix's scalars, every K11-K15, K17 and K18 call
   is held, and the post-state ends at the hashlib root of a fresh
   deserialization; K14, K13 and K12 are timed per launch at their 2^20
   calls; at 4,096
   validators with ``MIN_PER_EPOCH_CHURN_LIMIT = 16`` and 24 queued the
   spec loops, the columnar engine and the mesh engine give identical
   roots and activate the same 8, leaking and not;
21. (run right after phase 19) a mainnet EIP-7594 block through the
   port's ``state_transition`` on the card (``build_spec("eip7594",
   "mainnet")``): ``upgrade_to_eip7594`` of phase 19's 2^20-validator
   Deneb state after its cold root (a decode of its bytes: the copy; its
   cold root's span builds checked and held, every field's root but the
   fork's equal), a block at slot 3 with phase 19's content (the
   attestations, the sync aggregate, the proposer signature and the randao
   reveal signed under the EIP-7594 fork version, the 16 withdrawals,
   phase 19's 16 BLS-to-execution changes as they are, phase 8's six
   commitments with their blob transaction and gas: 147 RLC items).  One
   batch scope holds ``is_data_available`` (``retrieve_cells_and_proofs``
   hands back phase 9's 8 sampled columns, ``SAMPLES_PER_SLOT``, of each
   blob with their cells and proofs) and ``state_transition``: each
   blob's cell batch defers its two pairs, and the 147 items and six
   checks pass as one product pairing, one K4 launch of one group of 160
   pairs.  The post-state's hashlib root must equal the block's
   ``state_root`` and carry the EIP-7594 fork version; a withheld blob
   (five of six handed back) must answer False with no launch; outside a
   block, a scope holding only ``is_data_available`` with one element of
   one cell of blob 2 changed must fail its flush with
   ``last_pairing_results`` naming blob 2 alone; the 8 columns as
   ``DataColumnSidecar``s around the block's signed header must pass
   ``verify_data_column_sidecar`` and
   ``verify_data_column_sidecar_kzg_proofs`` (one K4 launch of 2 pairs
   each, outside a scope); blob 0 through ``recover_polynomial`` from
   phase 9's kept half must equal its extended cells (4 K9 launches, each
   held).  Every K1-K5, K7 and K8 call at a shape no earlier phase held
   is held against its plain version (K4's GT values too);
   the upgrade, ``is_data_available`` (card and host), the flush, K4 at
   160 pairs, the sidecar verifies and the recovery are timed.

The hashlib roots of phases 6, 10, 13, 14, 17, 18, 19, 20 and 21 (a fresh
deserialization of each large state, hashed without the batched hasher)
are recomputed in three worker processes while the run goes on; the run
waits for all of them, and fails on any that differs, before phase 16's
result lines.

Needs one CUDA device; without one it exits non-zero and prints no result.
The registry holds 1,024 keys, not mainnet's 2^20: the host-side
KeyValidate (decompression and subgroup check, ~31 ms of python per key,
paid once per registry key, not per block) dominates set-up otherwise;
the 2^20 validators of phases 6, 10, 13, 14, 17, 19, 20 and 21 cycle over
those keys.  The device work per block does not depend on the number of distinct keys; on
the host, the cycled keys also keep the spec's linear pubkey search in
``process_sync_aggregate`` cheap (every key occurs within the first 1,024
entries), which is why the port replaces it by one first-occurrence map.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

SEED = b"chip-smoke-v1"
REGISTRY = 1024
COMMITTEE = 512             # 2^20 validators / (32 slots x 64 committees)
ATTESTATIONS = 128          # MAX_ATTESTATIONS
SYNC = 512                  # SYNC_COMMITTEE_SIZE
KERNELS = ("g1_aggregate_scale", "g2_scale_sum", "hash_to_g2", "pairing_check")
VALIDATORS = 1 << 20        # mainnet's registry: committees of 512
BLOCK_SLOT = 3
FORGED = 37                 # the attestation whose signature is forged
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# 32-bit integer multiply-add throughput of an H100 SXM: 64 per clock per
# SM (compute capability 9.0 in the CUDA C++ Programming Guide's
# throughput table; a 32 x 32 -> 64 product is two of them, the low and
# the high half) x 132 SMs x 1.98 GHz boost clock
IMAD_PER_S = 64 * 132 * 1.98e9
# 32-bit integer logic (LOP3), shift and funnel-shift results, which only
# the integer ALU executes: the same table gives 64 per clock per SM at
# compute capability 9.0, so the same rate (derived, not measured)
INT32_OPS_PER_S = IMAD_PER_S


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str) -> list:
    """``nvcc -Xptxas -v`` output -> one line per entry function (registers,
    stack) plus the spill bytes of every function it reports."""
    out, entry, props, spills = [], None, None, []
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.rsplit(" ", 1)[-1]
        elif "bytes spill stores" in line and props:
            st, ld = line.split(",")[1].split()[0], line.split(",")[2].split()[0]
            if st != "0" or ld != "0":
                spills.append(f"{props} {st}/{ld}")
        elif "Used" in line and entry:
            out.append(f"entry {entry}: {line.split(':', 1)[1].strip()}")
            entry = None
    out.append("spills (stores/loads bytes): " + ("; ".join(spills) or "none"))
    return out


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def queued_ms(torch, fn, reps: int = 20) -> float:
    """Device ms per call of ``fn`` with the launches queued ahead: the card
    first spins (``torch.cuda._sleep``) while the host enqueues every
    call, so the events time the kernels back to back and not the host's
    launch overhead (which is longer than a short kernel)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profile_once(torch, fn):
    """One run of ``fn`` under torch.profiler: (wall ms, {event: device ms})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            dev[ev.key] = us / 1e3
    return wall, dev


class StageClock:
    """Host-side stage timer: wraps module attributes, sums their wall ms.
    With ``sync`` (``torch.cuda.synchronize``) each wrapped call waits for
    the card before and after, so a kernel wrapper's sum is the wall time
    of its launches and their execution."""

    def __init__(self, sync=None):
        self.ms, self.calls, self._undo, self.sync = {}, {}, [], sync

    def wrap(self, mod, name):
        fn = getattr(mod, name)

        def timed(*a, **kw):
            if self.sync:
                self.sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self.sync:
                    self.sync()
                self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
                self.calls[name] = self.calls.get(name, 0) + 1
        setattr(mod, name, timed)
        self._undo.append((mod, name, fn))

    def restore(self):
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo = []


def max_abs_err(a, b) -> int:
    """Largest word difference between two outputs (flags count as 0/1)."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def compare(torch, name, got, want) -> int:
    """Fail unless every output tensor of a kernel call equals its plain
    version's (outputs the call did not ask for are None on both sides);
    return the largest word difference (0)."""
    got, want = as_tuple(got), as_tuple(want)
    check(len(got) == len(want) and all(
        (g is None and w is None) or (g is not None and w is not None and torch.equal(g, w))
        for g, w in zip(got, want)), f"{name} differs from its plain version")
    return max([max_abs_err(g, w) for g, w in zip(got, want) if g is not None] or [0])


# ---------------------------------------------------------------------------
# slice 2: SHA-256 kernels and a mainnet phase0 block
# ---------------------------------------------------------------------------

def seeded_rows(n: int) -> bytes:
    """n seeded 64-byte rows; the first three all-zero, all-ones and
    top-bit-set (signed bit patterns once packed as int32 words)."""
    out = bytearray(hashlib.shake_256(SEED + b"rows" + n.to_bytes(4, "little"))
                    .digest(64 * n))
    for i, fill in enumerate((0x00, 0xFF, 0x80)[:n]):
        out[64 * i:64 * (i + 1)] = bytes([fill]) * 64
    return bytes(out)


# K6's edge shapes: messages (a lone thread, a partial warp on either side
# of one, the probe's 256 and one past it, in a partial CTA) and blocks
# (one: nothing loaded ahead; two, the probe's five, and 17)
K6_MESSAGES = (1, 31, 33, 256, 257)
K6_BLOCKS = (1, 2, 5, 17)
# the round-latency probe's two lengths (x 64 rounds): their difference
# cancels the launch
CHAIN_REPS = (64, 1088)


def k6_words(torch, sha256, m: int, nb: int, tag: bytes = b"") -> tuple:
    """m seeded messages whose padding gives nb blocks: (int32 (m, nb, 16)
    words on the host, the messages)."""
    msgs = [hashlib.shake_256(SEED + tag + bytes([nb]) + i.to_bytes(4, "little"))
            .digest(64 * (nb - 1) + i % 56) for i in range(m)]
    words = torch.stack([torch.from_numpy(sha256.pad_message(x).copy()) for x in msgs])
    check(tuple(words.shape) == (m, nb, 16), f"padding gave {tuple(words.shape)}")
    return words, msgs


def round_ns(torch, sha256, dev) -> float:
    """ns per round of one thread's dependent chain of SHA-256 rounds: the
    round-latency probe (``sha256.sha256_chain``) held against its plain
    version, then timed queued ahead at :data:`CHAIN_REPS` x 64 rounds;
    the difference of the two times over the difference of the rounds."""
    lo, hi = CHAIN_REPS
    for reps in (1, lo):
        got = sha256.sha256_chain(reps, dev).cpu()
        check(torch.equal(got, sha256.sha256_chain(reps, "cpu")),
              f"the round-latency probe differs from its plain version at {reps} x 64 rounds")
    t = {r: queued_ms(torch, lambda: sha256.sha256_chain(r, dev), 5) for r in CHAIN_REPS}
    return (t[hi] - t[lo]) * 1e6 / (64 * (hi - lo))


def sha_kernel_checks(torch, cu, sha256) -> dict:
    """Phase 5: K5 and K6 against their plain versions on the card and
    hashlib (K6 at every shape of :data:`K6_MESSAGES` x :data:`K6_BLOCKS`,
    on words that start on 16 bytes and one word off), the round-latency
    probe measured; returns the probe's ns per round and the 256
    five-block call's arguments for timing."""
    for n in (1, 3, 255, 256, 257, 4096):
        raw = seeded_rows(n)
        rows = torch.frombuffer(bytearray(raw), dtype=torch.uint8).reshape(n, 64).to(cu)
        got = sha256.hash64(rows)
        compare(torch, f"K5 (n={n})", got, sha256.hash64_plain(rows))
        want = b"".join(hashlib.sha256(raw[64 * i:64 * (i + 1)]).digest() for i in range(n))
        check(got.cpu().numpy().tobytes() == want, f"K5 differs from hashlib at n={n}")
    k6, calls = None, 0
    for nb in K6_BLOCKS:
        for m in K6_MESSAGES:
            words, msgs = k6_words(torch, sha256, m, nb)
            digests = b"".join(hashlib.sha256(x).digest() for x in msgs)
            w = words.to(cu)
            # the same words one word into a larger storage: off 16 bytes
            off = torch.zeros(words.numel() + 1, dtype=torch.int32, device=cu)[1:]
            off.copy_(w.reshape(-1))
            off = off.view(m, nb, 16)
            check(off.data_ptr() % 16 == 4, "the off-16 view starts on 16 bytes")
            want = sha256.sha256_blocks_plain(w)
            for lay, x in (("on 16 bytes", w), ("off 16 bytes", off)):
                got = sha256.sha256_blocks(x, nb)
                compare(torch, f"K6 ({m} messages, {nb} blocks, {lay})", got, want)
                check(got.cpu().numpy().astype(">u4").tobytes() == digests,
                      f"K6 differs from hashlib at {m} messages of {nb} blocks ({lay})")
                calls += 1
            if (m, nb) == (256, 5):
                k6 = (w, nb)
    check(sha256.sha256_bytes(b"abc", cu) == hashlib.sha256(b"abc").digest(), "sha256_bytes")
    ns = round_ns(torch, sha256, cu)
    check(ns > 0, f"the round-latency probe gave {ns} ns per round")
    print(f"kernel checks (small inputs): K5 at n = 1, 3, 255, 256, 257, 4096 and K6 at "
          f"m = {K6_MESSAGES} x nb = {K6_BLOCKS}, on and off 16 bytes ({calls} calls) "
          f"byte-identical to their plain versions on the card and to hashlib (tolerance 0: "
          f"bytes); the round-latency probe equal to its plain version, {ns:.4f} ns per "
          f"dependent round")
    return {"sha256_blocks": k6, "round_ns": ns}


def with_chain_floor(entry: dict, chain_ops: int, ns_per_round: float) -> dict:
    """Add a kernel entry's chain floor in ms (``chain_ops`` dependent
    instructions, 4 a round, at the measured ns per round) and make its
    bound the larger of the bound it had and the chain floor;
    ``bound_term`` names which of ops, bytes and chain bounds."""
    chain_ms = chain_ops / 4 * ns_per_round * 1e-6
    entry.update(chain_ops=chain_ops, chain_ms=chain_ms, round_ns=ns_per_round)
    entry.setdefault("bound_term", "ops" if entry["bound_by"] == "operations" else "bytes")
    if chain_ms > entry["bound_ms"]:
        entry.update(bound_ms=chain_ms, bound_by="operations", bound_term="chain")
    return entry


class HasherClock:
    """Wall ms spent inside the merkle engine's installed batched hasher
    (staging copy, H2D, K5, D2H), both entry points."""

    def __init__(self, merkle):
        self.merkle, self.ms = merkle, 0.0
        self.fns = (merkle._batched_hasher, merkle._batched_hasher_np)

    def _timed(self, fn):
        def timed(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3
        timed.device = getattr(fn, "device", None)     # span builds run there
        return timed

    def __enter__(self):
        self.merkle.set_batched_hasher(self._timed(self.fns[0]))
        self.merkle.set_batched_hasher_np(self._timed(self.fns[1]))
        return self

    def __exit__(self, *exc):
        self.merkle.set_batched_hasher(self.fns[0])
        self.merkle.set_batched_hasher_np(self.fns[1])


def hashlib_root_job(fork: str, data: bytes) -> tuple:
    """A mainnet ``fork`` state's root recomputed the independent way, in a
    worker process: deserialize ``data`` afresh, hash with no batched
    hasher (hashlib only).  Returns (root, deserialize s, hashing s)."""
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.utils import ssz
    from consensus_specs_tpu_torch.utils.ssz import merkle
    typ = build_spec(fork, "mainnet").BeaconState
    t0 = time.perf_counter()
    fresh = ssz.deserialize(typ, data)
    t1 = time.perf_counter()
    merkle.set_batched_hasher(None)
    merkle.set_batched_hasher_np(None)
    root = bytes(ssz.hash_tree_root(fresh))
    return root, t1 - t0, time.perf_counter() - t1


class HashlibRoots:
    """The hashlib recomputes of the 2^20-validator roots, each in a
    worker process while the run goes on: ``submit`` serializes the state
    here, ``finish`` waits for every recompute and fails the run on any
    root that differs.  ``close`` stops the workers."""

    WORKERS = 3

    def __init__(self):
        self.pool, self.jobs = None, []

    def submit(self, what: str, spec, ssz, state, want: bytes) -> None:
        if self.pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self.pool = ProcessPoolExecutor(self.WORKERS, mp_context=mp.get_context("spawn"))
        t0 = time.perf_counter()
        data = bytes(ssz.serialize(state))
        t_ser = time.perf_counter() - t0
        self.jobs.append((what, want, t_ser,
                          self.pool.submit(hashlib_root_job, type(spec).fork, data)))

    def finish(self) -> None:
        for what, want, t_ser, job in self.jobs:
            root, t_de, t_hl = job.result()
            check(root == want, f"{what}: the hashlib root {root.hex()} differs from "
                                f"{want.hex()}")
            print(f"hashlib root of {what}: equal to the run's ({t_ser:.2f} s serialize here; "
                  f"in a worker {t_de:.2f} s deserialize afresh, {t_hl:.2f} s hashing)")
        self.jobs = []

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(cancel_futures=True)
            self.pool = None


hashlib_roots = HashlibRoots()


def build_registry_state(spec, ssz, np, pks, n: int, scatter=None):
    """A mainnet ``BeaconState`` at slot 0 with ``n`` active validators at
    32 ETH, validator i keyed by registry key i mod len(pks).  The
    registry and balances are built as numpy SSZ buffers (``scatter(rec,
    bal)`` may edit the (n, 121) record bytes and the balances first) and
    deserialized; nothing is hashed."""
    from consensus_specs_tpu_torch.utils.hash_function import hash as sha
    far = 2**64 - 1
    keys = np.frombuffer(b"".join(pks), dtype=np.uint8).reshape(len(pks), 48)
    creds = np.frombuffer(b"".join(spec.BLS_WITHDRAWAL_PREFIX + sha(pk)[1:] for pk in pks),
                          dtype=np.uint8).reshape(len(pks), 32)
    rec = np.zeros((n, 121), dtype=np.uint8)
    idx = np.arange(n) % len(pks)
    rec[:, :48] = keys[idx]
    rec[:, 48:80] = creds[idx]
    fields = np.array([spec.MAX_EFFECTIVE_BALANCE], dtype="<u8").view(np.uint8)
    rec[:, 80:88] = fields                                   # effective_balance
    rec[:, 89:105] = 0                                       # eligibility, activation
    rec[:, 105:121] = np.array([far, far], dtype="<u8").view(np.uint8)   # exit, withdrawable
    block_hash = hashlib.sha256(SEED + b"eth1").digest()
    state = spec.BeaconState(
        genesis_time=1606824023,
        genesis_validators_root=hashlib.sha256(SEED + b"genesis").digest(),
        fork=spec.Fork(previous_version=spec.config.GENESIS_FORK_VERSION,
                       current_version=spec.config.GENESIS_FORK_VERSION, epoch=0),
        latest_block_header=spec.BeaconBlockHeader(
            body_root=ssz.hash_tree_root(spec.BeaconBlockBody())),
        eth1_data=spec.Eth1Data(deposit_root=hashlib.sha256(SEED + b"deposits").digest(),
                                deposit_count=n, block_hash=block_hash),
        eth1_deposit_index=n,
        randao_mixes=[block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
    )
    bal = np.full(n, spec.MAX_EFFECTIVE_BALANCE, dtype="<u8")
    if scatter is not None:
        scatter(rec, bal)
    state.validators = ssz.deserialize(type(state.validators), rec.tobytes())
    state.balances = ssz.deserialize(type(state.balances), bal.tobytes())
    return state


def two_rejections(spec, state, block, signed, forged, item: int, what: str, tag: str,
                   wrong_root: bool = True) -> None:
    """``forged`` (``block`` with one signature replaced; ``what``) must
    raise in ``state_transition`` of a copy of ``state`` with
    ``last_results`` naming its batch item ``item`` alone, and, with
    ``wrong_root``, ``block`` with a wrong ``state_root`` must raise at
    the root check with every signature passing (phase 6 holds that leg:
    the root check is ``Phase0Spec.state_transition``'s, which no later
    fork overrides).  ``signed`` signs a block message as its proposer."""
    from consensus_specs_tpu_torch.utils import bls
    wrong = block.copy()
    wrong.state_root = b"\x01" * 32
    bls.clear_verify_memo()
    batches = []
    legs = ((forged, what), (wrong, "a wrong state_root"))[:2 if wrong_root else 1]
    for msg, name in legs:
        with bls.scoped_batch(bls.DeferredBatch()) as batch:
            try:
                spec.state_transition(state.copy(), signed(msg))
                fail(f"{tag}: {name} passed state_transition")
            except AssertionError:
                pass
        batches.append(batch)
    failed = [i for i, ok in enumerate(batches[0].last_results) if not ok]
    check(failed == [item], f"{tag}: {what} not isolated: {failed}")
    if wrong_root:
        check(batches[1].last_results is not None and all(batches[1].last_results),
              f"{tag}: the wrong-root block must fail at the root check, not at a signature")
    print(f"{tag}: {what}: AssertionError, last_results names item {failed} alone"
          + ("; a wrong state_root: AssertionError at the state-root check (signatures passed)"
             if wrong_root else ""))


def phase0_block(torch, dev, card, sks, pks, n_validators: int) -> tuple:
    """Phase 6: a mainnet phase0 block through ``state_transition`` on
    ``dev``.  Returns the K5 entry of the ``kernels`` line, the launch
    counts of the transition, the pre-state (slot 0, untouched), which
    phase 13 upgrades to Altair, the cold root's K18 record, and the
    largest word difference of each K1-K4 call of the transition held
    against its plain version (0)."""
    import numpy as np
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import att_prep, bls_rlc, bls_torch, sha256
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as O
    from consensus_specs_tpu_torch.ops.bls12_381.fields import R_ORDER
    from consensus_specs_tpu_torch.ops.torch_bls import htc, pairing, points
    from consensus_specs_tpu_torch.parallel import mesh_merkle
    from consensus_specs_tpu_torch.utils import bls, ssz
    from consensus_specs_tpu_torch.utils.ssz import merkle

    spec = build_spec("phase0", "mainnet")
    bls.use_torch(dev)
    sha256.install_merkle_hasher(dev)

    t0 = time.perf_counter()
    state = build_registry_state(spec, ssz, np, pks, n_validators)
    t_state = time.perf_counter() - t0
    print(f"phase0: state of {n_validators} active validators (keys cycle over "
          f"{len(pks)}); reduced: registry keys {len(pks)} (mainnet: one per "
          f"validator); set-up: state build {t_state:.2f} s (host)")

    # -- the cold root: K5 and K18 against hashlib --------------------------------
    merkle.reset_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    with CallRecorder(torch, sha256, "hash64", first_of_shape=True) as cold, \
            CallRecorder(torch, mesh_merkle, "merkle_levels") as spans, \
            HasherClock(merkle) as hclock:
        t0 = time.perf_counter()
        root_k5 = bytes(ssz.hash_tree_root(state))
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
    cold_launches = dict(_build.launches)
    cold_stats = merkle.stats()
    # the span builds (those the floor engages): validators, balances and
    # the fixed vectors (block and state roots, randao mixes, slashings)
    k18_check("the cold root", spans.calls, cold_launches["merkle_levels"],
              [n_validators, -(-n_validators // 4), int(spec.SLOTS_PER_HISTORICAL_ROOT),
               int(spec.SLOTS_PER_HISTORICAL_ROOT), int(spec.EPOCHS_PER_HISTORICAL_VECTOR),
               int(spec.EPOCHS_PER_SLASHINGS_VECTOR) // 4])
    check(cold_launches["hash64"] == COLD_K5.get(n_validators, cold_launches["hash64"]) > 0,
          f"the cold root must launch K5 {COLD_K5.get(n_validators, 'some')} times: "
          f"{cold_launches}")
    hashlib_roots.submit("the phase0 cold state", spec, ssz, state, root_k5)
    k18_err = spans.hold(mesh_merkle.merkle_levels_plain)
    print(f"cold root: {root_k5.hex()} equal on K5 and K18 (hashlib: a worker's); card path "
          f"{t_cold:.3f} s (in the batched hasher {hclock.ms / 1e3:.3f} s; K5 {cold.count} "
          f"launches; K18 {cold_launches['merkle_levels']} launches in {spans.count} span "
          f"builds at leaves {sorted(a[0].shape[0] for a, _ in spans.calls)}, each held "
          f"against its plain version); pairs by K5 {cold_stats['pairs_batched']}, by hashlib "
          f"{cold_stats['pairs_hashlib']} on {card}")

    # -- the block -------------------------------------------------------------
    dry = state.copy()
    t0 = time.perf_counter()
    spec.process_slots(dry, BLOCK_SLOT)
    t_slots_dry = time.perf_counter() - t0
    proposer = int(spec.get_beacon_proposer_index(dry))

    def sk_of(v):
        return sks[v % len(sks)]

    t0 = time.perf_counter()
    committees = {(s, c): spec.get_beacon_committee(dry, s, c)
                  for s in (1, 2)
                  for c in range(int(spec.get_committee_count_per_slot(dry, 0)))}
    t_comm = time.perf_counter() - t0
    att_domain = spec.get_domain(dry, spec.DOMAIN_BEACON_ATTESTER, 0)
    t0 = time.perf_counter()
    atts = []
    for (s, c), members in committees.items():
        data = spec.AttestationData(
            slot=s, index=c, beacon_block_root=spec.get_block_root_at_slot(dry, s),
            source=dry.current_justified_checkpoint,
            target=spec.Checkpoint(epoch=0, root=spec.get_block_root(dry, 0)))
        sk = sum(sk_of(v) for v in members) % R_ORDER
        atts.append(spec.Attestation(
            aggregation_bits=[True] * len(members), data=data,
            signature=O.Sign(sk, spec.compute_signing_root(data, att_domain))))
    randao = O.Sign(sk_of(proposer), spec.compute_signing_root(
        spec.uint64(0), spec.get_domain(dry, spec.DOMAIN_RANDAO)))
    t_sign = time.perf_counter() - t0
    block = spec.BeaconBlock(
        slot=BLOCK_SLOT, proposer_index=proposer,
        parent_root=ssz.hash_tree_root(dry.latest_block_header),
        body=spec.BeaconBlockBody(randao_reveal=randao, eth1_data=dry.eth1_data,
                                  attestations=atts))
    n_keys = sum(len(m) for m in committees.values()) + 2
    print(f"block: slot {BLOCK_SLOT}, proposer {proposer}, {len(atts)} attestations "
          f"(committees of {len(next(iter(committees.values())))}), {len(atts) + 2} RLC "
          f"items, {n_keys} keys; set-up: committees {t_comm:.2f} s ({len(committees)} "
          f"computed, {t_comm / len(committees) * 1e3:.1f} ms each), signing "
          f"{t_sign:.2f} s (host)")

    signed = proposer_signer(spec, dry, sks, proposer)

    # the state root from a dry run of the transition on the copy
    bls.bls_active = False
    t0 = time.perf_counter()
    spec.process_block(dry, block.copy())
    block.state_root = ssz.hash_tree_root(dry)
    t_dry = time.perf_counter() - t0
    bls.bls_active = True
    del dry
    print(f"dry run on a copy: process_slots {t_slots_dry:.2f} s, process_block + root "
          f"{t_dry:.2f} s (recomputes the {len(committees)} committees: the randao reveal "
          f"changes the cache key)")

    # -- the transition on the card ------------------------------------------------
    clock = StageClock()
    post = state.copy()
    good = signed(block.copy())
    for name in ("process_slots", "process_block"):
        clock.wrap(spec, name)
    clock.wrap(att_prep, "prepare_block_attestations")
    clock.wrap(bls.DeferredBatch, "flush")
    clock.wrap(bls_rlc, "derive_scalars")
    for name in ("_decompress_g2", "_stack_pk_rows", "hash_to_field_host"):
        clock.wrap(bls_torch, name)
    bls.clear_verify_memo()
    merkle.reset_stats()
    bls_recs = [CallRecorder(torch, bls_torch, k) for k in KERNELS]
    torch.cuda.synchronize()
    with CallRecorder(torch, sha256, "hash64") as rec:
        for r in bls_recs:
            r.__enter__()
        _build.reset_launches()
        t0 = time.perf_counter()
        with bls.scoped_batch(bls.DeferredBatch()) as batch:
            spec.state_transition(post, good)
        torch.cuda.synchronize()
        t_total = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.launches)
        for r in reversed(bls_recs):
            r.__exit__()
    clock.restore()
    tr_stats = merkle.stats()
    check(batch.pairings == 1, f"expected one product pairing, got {batch.pairings}")
    check(batch.last_results == [True] * (len(atts) + 2), "last_results must be all True")
    path_kernels = KERNELS + ("hash64",)
    check(all(launches[k] > 0 for k in path_kernels),
          f"a kernel of the transition was not launched: {launches}")
    ms = clock.ms
    block_rest = ms["process_block"] - ms["prepare_block_attestations"] - ms["flush"]
    root_ms = t_total - ms["process_slots"] - ms["process_block"]
    print(f"state_transition: passed with {batch.pairings} product pairing, "
          f"{len(batch.last_results)} items; launches {launches}")
    print(f"time state_transition (validate_result=True): {t_total:.2f} ms = slots "
          f"{ms['process_slots']:.2f} ({ms['process_slots'] / BLOCK_SLOT:.2f} per empty "
          f"slot) + att_prep {ms['prepare_block_attestations']:.2f} + flush "
          f"{ms['flush']:.2f} + rest of process_block {block_rest:.2f} + state-root "
          f"check and block signature {root_ms:.2f}; K5 launches "
          f"{rec.count} at rows {sorted({a[0].shape[0] for a, _ in rec.calls})}; pairs by K5 "
          f"{tr_stats['pairs_batched']}, by hashlib {tr_stats['pairs_hashlib']} on {card}")
    print(f"flush host stages (ms, wall clock): _decompress_g2 {ms['_decompress_g2']:.2f} "
          f"({len(atts) + 2} new signatures), _stack_pk_rows {ms['_stack_pk_rows']:.2f}, "
          f"derive_scalars {ms['derive_scalars']:.2f}, hash_to_field_host "
          f"{ms['hash_to_field_host']:.2f}; rest of the flush (kernels, waits) "
          f"{ms['flush'] - ms['_decompress_g2'] - ms['_stack_pk_rows'] - ms['derive_scalars'] - ms['hash_to_field_host']:.2f} on {card}")

    # one more run of the same transition under the profiler: device busy
    # time and idle share (the signatures' decompression is cached now)
    prof_state, prof_block = state.copy(), good.copy()
    bls.clear_verify_memo()

    def transition():
        with bls.scoped_batch(bls.DeferredBatch()):
            spec.state_transition(prof_state, prof_block)
    prof_wall, dev_ms = profile_once(torch, transition)
    busy = sum(dev_ms.values())
    del prof_state
    top = ", ".join(f"{k} {v:.3f}" for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8])
    print(f"state_transition profile (second run, signatures already decompressed): wall "
          f"{prof_wall:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / prof_wall:.3f}; device ms by event: {top} on {card}")

    hashlib_roots.submit("the phase0 block's post-state (the block's state_root)", spec, ssz,
                         post, bytes(block.state_root))
    del post
    plain = {"g1_aggregate_scale": points.g1_aggregate_scale_plain,
             "g2_scale_sum": points.g2_scale_sum_plain, "hash_to_g2": htc.hash_to_g2_plain,
             "pairing_check": k4_gt_plain(torch, pairing)}
    bls_err = {r.name: r.hold(plain[r.name]) for r in bls_recs}
    print(f"phase0: every K1-K4 call of the transition (K4's GT values too) held against "
          f"their plain versions ({ {r.name: r.count for r in bls_recs} } calls, K2 at "
          f"{[a[0].shape[0] for a, _ in bls_recs[1].calls]} lanes, K3 at "
          f"{[a[0].shape[0] for a, _ in bls_recs[2].calls]} messages)")

    # -- the two rejections ---------------------------------------------------------
    forged = block.copy()
    forged.body.attestations[FORGED].signature = forged.body.attestations[0].signature
    # items: the proposer signature, the randao reveal, the attestations
    two_rejections(spec, state, block, signed, forged, FORGED + 2,
                   f"a forged attestation {FORGED} signature", "phase0")

    # -- K5 at the transition's shapes, the cold root's largest launch and one
    # launch per level; timings ------------------------------------------------------
    fn = rec.fn
    err = max(rec.hold(sha256.hash64_plain), cold.hold(sha256.hash64_plain))
    rec_rows = [a[0] for a, _ in rec.calls]
    cold_rows = [a[0] for a, _ in cold.calls]
    big = max(cold_rows, key=lambda r: r.shape[0])
    print(f"check hash64: equal to its plain version at every transition launch "
          f"{[r.shape[0] for r in rec_rows]} and at the cold root's first launch of every "
          f"row count ({len(cold_rows)} shapes, largest {big.shape[0]})")
    shape = max(rec_rows, key=lambda r: r.shape[0])
    n = shape.shape[0]
    # device ms per launch queued ahead, at each row count the transition
    # launched (with its launches) and at the cold root's
    rec_ms = {}
    for rows in rec_rows:
        m = int(rows.shape[0])
        if m not in rec_ms:
            rec_ms[m] = {"ms": queued_ms(torch, lambda: fn(rows), 20),
                         "launches": rec.by_shape[str([tuple(rows.shape)])]}
    k_ms = rec_ms[n]["ms"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sha256.hash64_plain(shape)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    big_ms = queued_ms(torch, lambda: fn(big), 10)
    cold_kernel_ms = 0.0
    for rows in cold_rows:
        count = cold.by_shape[str([tuple(rows.shape)])]
        cold_kernel_ms += queued_ms(torch, lambda: fn(rows), 10) * count
    one = shape[:1].contiguous()
    one_ms = queued_ms(torch, lambda: fn(one), 20)

    def bound(m):
        ops = sha256.hash64_int_ops(m) / INT32_OPS_PER_S
        return max(ops, 96 * m / HBM_BYTES_PER_S) * 1e3, ops * 1e3

    b_ms, _ = bound(n)
    big_b, big_ops = bound(big.shape[0])
    host_big = big.cpu().numpy().tobytes()
    t0 = time.perf_counter()
    for i in range(0, len(host_big), 64):
        hashlib.sha256(host_big[i:i + 64]).digest()
    hl_big_ms = (time.perf_counter() - t0) * 1e3
    pinned = torch.empty(big.shape, dtype=torch.uint8, pin_memory=True)
    h2d_ms = cuda_ms(torch, lambda: pinned.to(dev, non_blocking=True))
    out = fn(big)
    d2h_ms = cuda_ms(torch, lambda: out.cpu())
    small_pinned = torch.empty((n, 64), dtype=torch.uint8, pin_memory=True)
    small_h2d = cuda_ms(torch, lambda: small_pinned.to(dev, non_blocking=True))
    small_out = fn(shape)
    small_d2h = cuda_ms(torch, lambda: small_out.cpu())
    print(f"time hash64 at the transition's launches (rows: ms per launch queued ahead, "
          f"launches): " + ", ".join(f"{m}: {v['ms']:.5f}, {v['launches']}"
                                     for m, v in sorted(rec_ms.items()))
          + f"; at its largest (n={n}) {k_ms:.5f} ms (plain {p_ms:.1f} ms, bound {b_ms:.7f} ms"
          f" by operations; chain floor {sha256.hash64_chain_ops()} dependent instructions; "
          f"one row {one_ms:.5f} ms); "
          f"H2D {small_h2d:.4f} ms, D2H {small_d2h:.4f} ms per call on {card}")
    print(f"time hash64 at the cold root's largest launch (n={big.shape[0]}): "
          f"{big_ms:.4f} ms queued ahead (bound {big_b:.4f} ms by operations {big_ops:.4f} ms, bytes "
          f"{96 * big.shape[0] / HBM_BYTES_PER_S * 1e3:.4f} ms; hashlib on the host "
          f"{hl_big_ms:.1f} ms); H2D {h2d_ms:.3f} ms, D2H {d2h_ms:.3f} ms; all "
          f"{cold.count} cold-root launches {cold_kernel_ms:.3f} ms of "
          f"kernel time on {card}")
    return {"name": "hash64", "route": "cuda",
            "source": "consensus_specs_tpu_torch/csrc/sha256.cu",
            "replaces": "consensus_specs_tpu/ops/sha256.py:104",
            "launches": launches["hash64"], "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": "operations" if bound(n)[1] >= 96 * n / HBM_BYTES_PER_S * 1e3
            else "bytes",
            "library_ms": None, "rows": n, "transition_shapes": rec_ms,
            "chain_ops": sha256.hash64_chain_ops(),
            "one_row_ms": one_ms, "h2d_ms": small_h2d, "d2h_ms": small_d2h,
            "hashlib_ms_at_cold_max": hl_big_ms, "cold_max_rows": int(big.shape[0]),
            "cold_max_ms": big_ms, "cold_kernel_ms": cold_kernel_ms,
            "cold_root_s": t_cold}, launches, state, \
        {"calls": spans.calls, "launches": cold_launches["merkle_levels"], "err": k18_err}, \
        bls_err


def sha256_blocks_entry(torch, card, sha256, args, launches: int, ns_per_round: float) -> dict:
    """The K6 entry of the ``kernels`` line, timed at its 256 five-block
    call; ``launches`` is its count in the transition (K6 is a test aid,
    not on the transition's path: 0).  Its bound is the larger of
    operations, bytes and the chain floor at the measured ns per round."""
    w, nb = args
    m = w.shape[0]
    k_ms = queued_ms(torch, lambda: sha256.sha256_blocks(w, nb), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sha256.sha256_blocks_plain(w)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    err = compare(torch, "K6", sha256.sha256_blocks(w, nb), want)
    ops_ms = sha256.sha256_blocks_int_ops(m, nb) / INT32_OPS_PER_S * 1e3
    bytes_ms = (64 * nb + 32) * m / HBM_BYTES_PER_S * 1e3
    entry = with_chain_floor({
        "name": "sha256_blocks", "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256.cu",
        "replaces": "consensus_specs_tpu/ops/sha256.py:141",
        "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "messages": m, "blocks": nb},
        sha256.sha256_blocks_chain_ops(nb), ns_per_round)
    print(f"time sha256_blocks at {m} messages of {nb} blocks: {k_ms:.5f} ms queued ahead; "
          f"bound {entry['bound_ms']:.6f} ms by {entry['bound_term']} (operations {ops_ms:.7f}, bytes {bytes_ms:.7f}, chain floor "
          f"{entry['chain_ops']} dependent instructions at {ns_per_round:.4f} ns a round -> "
          f"{entry['chain_ms']:.6f} ms: {entry['chain_ms'] / k_ms:.1%} of it reached); plain "
          f"{p_ms:.1f} ms on the card, on {card}")
    return entry


# ---------------------------------------------------------------------------
# slice 3: a block's blobs through the KZG library, PeerDAS recovery and
# sampling
# ---------------------------------------------------------------------------

MSM_SIZES = (1, 3, 8, 300)
# K7 alone at sizes that fill no warp of 8 teams (with points at infinity)
K7_SIZES = (5, 6, 33)
# K8's skewed inputs (phase 7): the one-bucket and single-lane MSMs, and the
# one with every other point at infinity
K8_SKEW_POINTS = (1024, 4096)
FFT_SIZES = (2, 256, 8192)
BLOBS = 6                   # MAX_BLOBS_PER_BLOCK (presets/mainnet/deneb.yaml)
SAMPLED_COLUMNS = 8         # columns whose cell proofs are made and checked
# host stages timed inside the batch verify of the blobs (ops/kzg.py) and
# inside the cell proofs (ops/kzg_7594.py); none calls another
VERIFY_HOST_STAGES = ("validate_kzg_g1", "blob_to_polynomial", "compute_challenge",
                      "evaluate_polynomial_in_evaluation_form", "_to_g1")
PROOF_HOST_STAGES = ("polynomial_eval_to_coeff", "evaluate_polynomialcoeff",
                     "interpolate_polynomialcoeff", "vanishing_polynomialcoeff",
                     "divide_polynomialcoeff")


class CallRecorder:
    """Wraps ``mod.name`` while active: counts its calls (``count``, and
    per argument shape ``by_shape``) and keeps, per call (or per argument
    shape with ``first_of_shape``), clones of its tensor arguments before
    the call and of its outputs after it, so an in-place kernel is caught
    on both sides.  A tensor passed twice in one call is cloned once, so
    a replay reads the same buffers the call read.  ``canon``: the form
    in which outputs are compared (default: as they are)."""

    def __init__(self, torch, mod, name, first_of_shape=False, canon=None):
        self.torch, self.mod, self.name = torch, mod, name
        self.fn = getattr(mod, name)
        self.first_of_shape = first_of_shape
        self.canon = canon or (lambda out: out)
        self.calls, self.kwargs, self.count, self.by_shape = [], [], 0, {}

    def _clone(self, xs, memo=None):
        """Tensors cloned, also inside tuples, lists and dicts; one clone
        per tensor within a ``memo``."""
        memo = {} if memo is None else memo
        T = self.torch.Tensor
        if isinstance(xs, T):
            if id(xs) not in memo:
                memo[id(xs)] = xs.clone()
            return memo[id(xs)]
        if isinstance(xs, dict):
            return {k: self._clone(v, memo) for k, v in xs.items()}
        if isinstance(xs, (tuple, list)) and not hasattr(xs, "_fields"):
            return type(xs)(self._clone(x, memo) for x in xs)
        return xs

    def shapes(self, args):
        return [tuple(x.shape) for x in args if isinstance(x, self.torch.Tensor)]

    def __enter__(self):
        def wrapped(*a, **kw):
            shape = str(self.shapes(a))
            keep = not self.first_of_shape or shape not in self.by_shape
            memo = {}
            before = (self._clone(a, memo), self._clone(kw, memo)) if keep else None
            out = self.fn(*a, **kw)
            self.count += 1
            self.by_shape[shape] = self.by_shape.get(shape, 0) + 1
            if keep:
                self.calls.append((before[0], self._clone(tuple(as_tuple(out)))))
                self.kwargs.append(before[1])
            return out
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)

    def hold(self, plain) -> int:
        """Fail unless ``plain`` on every kept call's arguments gives that
        call's outputs; returns the largest word difference (0)."""
        err = 0
        for (args, out), kw in zip(self.calls, self.kwargs):
            memo = {}
            want = plain(*self._clone(args, memo), **self._clone(kw, memo))
            err = max(err, compare(self.torch, f"{self.name} at {self.shapes(args)}",
                                   self.canon(out), self.canon(tuple(as_tuple(want)))))
        return err


def sswu_square(u) -> bool:
    """Whether SSWU takes x1 for the oracle Fq2 ``u`` (g(x1) a square)."""
    from consensus_specs_tpu_torch.ops.bls12_381 import hash_to_curve as OH
    from consensus_specs_tpu_torch.ops.bls12_381.fields import Fq2
    A, B, Z = OH.A_PRIME, OH.B_PRIME, OH.Z_SSWU
    zu2 = Z * u.square()
    tv = zu2.square() + zu2
    x1 = B * (Z * A).inv() if tv.is_zero() else (-B) * A.inv() * (Fq2.one() + tv.inv())
    return (x1.square() * x1 + A * x1 + B).is_square()


K1_EDGE_SCALARS = (0, 1, (1 << 128) - 1, 1 << 77,                  # a single set bit
                   ((1 << 128) - 1) ^ (((1 << 70) - 1) << 30),     # long runs of ones, zeros
                   0x5A5A_0000_0000_FFFF_FFFF_0000_0001_8000)


def k1_edges(torch, dev) -> int:
    """K1 on rows of 0, 1 and N = 90 keys (the 40 teams hold 2 or 3), a row
    P, -P (the identity), a key repeated 7 times and 82 keys that cancel in
    pairs across teams, with the scalars 0, 1, 2^128 - 1, a single set bit,
    long runs of ones and of zeros and a mixed one (each row meeting two of
    them), and without scalars.  Each call against its plain version and
    the oracle.  Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR, G1Point
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    from consensus_specs_tpu_torch.ops.torch_bls import points
    n = 90
    keys = [G1_GENERATOR.mult(v) for v in field_elements(b"k1-edges", 50, 1 << 64)]
    rows = [[], [keys[0]], [keys[i % 50] for i in range(n)], [keys[1], -keys[1]],
            [keys[2]] * 7, [keys[i] for i in range(41)] + [-keys[i] for i in range(41)]]
    pk = torch.zeros((len(rows), n, 2, 12), dtype=torch.int32)
    for i, r in enumerate(rows):
        if r:
            pk[i, :len(r)] = C.pack_g1(r)[0]
    cnt = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    pk = pk.to(dev)
    sums = []
    for r in rows:
        acc = G1Point.inf()
        for p in r:
            acc = acc + p
        sums.append(acc)
    err = 0
    for shift in (None, 0, 3):
        sc, want = None, [p.to_compressed() for p in sums]
        if shift is not None:
            ks = [K1_EDGE_SCALARS[(i + shift) % len(K1_EDGE_SCALARS)] for i in range(len(rows))]
            raw = b"".join(v.to_bytes(16, "little") for v in ks)
            sc = torch.from_numpy(np.frombuffer(raw, dtype=np.int32).reshape(-1, 4).copy()).to(dev)
            want = [p.mult(k).to_compressed() for p, k in zip(sums, ks)]
        got = points.g1_aggregate_scale(pk, cnt, sc)
        tag = "no scalars" if shift is None else f"scalars shifted by {shift}"
        err = max(err, compare(torch, f"K1 (edges, {tag})", got,
                               points.g1_aggregate_scale_plain(pk, cnt, sc)))
        check([p.to_compressed() for p in C.unpack_g1(*got)] == want,
              f"K1 differs from the oracle on the edge rows ({tag})")
    print(f"check K1 edges: rows of {[len(r) for r in rows]} keys (P and -P, a repeated key, "
          f"82 cancelling keys), scalars 0, 1, 2^128 - 1, 2^77, long runs, and none: equal to "
          f"the plain version and the oracle")
    return err


def k2_k3_edges(torch, dev) -> int:
    """K3 on u = 0, on u's with zero imaginary parts and on seeded u's
    that take x1 and x2 in either half; K2 on an all-infinity batch, on
    lanes P and -P (the sum is the identity), on zero scalars and on a
    repeated signature.  Each against its plain version and the oracle.
    Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops.bls12_381 import hash_to_curve as OH
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G2_GENERATOR, G2Point
    from consensus_specs_tpu_torch.ops.bls12_381.fields import P, Fq2
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    from consensus_specs_tpu_torch.ops.torch_bls import htc, points
    from consensus_specs_tpu_torch.ops.torch_bls import limbs as L
    vals = iter(field_elements(b"k3-edges", 256, P))
    us = {True: [], False: []}                  # two u's taking x1, two taking x2
    while min(len(v) for v in us.values()) < 2:
        u = Fq2(next(vals), next(vals))
        us[sswu_square(u)].append(u)
    sq, nsq = us[True], us[False]
    pairs = [(Fq2(0, 0), Fq2(0, 0)), (Fq2(next(vals), 0), Fq2(0, 0)),
             (sq[0], nsq[0]), (nsq[1], sq[1])]
    words = torch.from_numpy(L.words_from_ints(
        [c for p in pairs for x in p for c in (x.a.n, x.b.n)]).reshape(len(pairs), 2, 2, 12).copy())
    u = words.to(dev)
    got = htc.hash_to_g2(u)
    err = compare(torch, "K3 (edges)", got, htc.hash_to_g2_plain(u))
    oracle = [OH.clear_cofactor(G2Point(*OH.iso_map_g2(*OH.map_to_curve_sswu(a)))
                                + G2Point(*OH.iso_map_g2(*OH.map_to_curve_sswu(b))))
              for a, b in pairs]
    check(C.unpack_g2(*got) == oracle, "K3 differs from the oracle on the edge u's")
    branches = [(sswu_square(a), sswu_square(b)) for a, b in pairs]
    print(f"check K3 edges: u = 0, a real u, and u's taking (x1 or x2) per half {branches}: "
          f"equal to the plain version and the oracle")
    g = [G2_GENERATOR.mult(v) for v in field_elements(b"k2-edges", 3, 1 << 64)]
    cases = {"all infinity": ([G2Point.inf()] * 3, [5, 7, 1 << 127]),
             "P and -P": ([g[0], -g[0]], [9, 9]),
             "zero scalars and a repeated signature": ([g[1], g[2], g[1], g[1]],
                                                       [0, 3, (1 << 128) - 1, 0]),
             "one lane": ([g[2]], [1])}
    for tag, (sigs, scalars) in cases.items():
        sw, si = (t.to(dev) for t in C.pack_g2(sigs))
        raw = b"".join(v.to_bytes(16, "little") for v in scalars)
        sc = torch.from_numpy(np.frombuffer(raw, dtype=np.int32).reshape(-1, 4).copy()).to(dev)
        got = points.g2_scale_sum(sw, si, sc)
        err = max(err, compare(torch, f"K2 (edges, {tag})", got,
                               points.g2_scale_sum_plain(sw, si, sc)))
        acc = G2Point.inf()
        for p, k in zip(sigs, scalars):
            acc = acc + p.mult(k)
        check(C.unpack_g2(got[0][None], got[1].reshape(1))[0] == acc,
              f"K2 differs from the oracle ({tag})")
    print(f"check K2 edges: {', '.join(cases)}: equal to the plain version and the oracle")
    return err


def k4_gt_plain(torch, pairing):
    """K4's plain version for a hold that also holds the kernel's GT
    values: on the call's arguments ``pairing_check_gt`` (one more launch
    of the kernel, which also writes each group's f^(3 (p^12 - 1) / r))
    must equal ``pairing_check_gt_plain`` byte for byte, verdicts and
    values; returns the plain verdicts, which the hold compares with the
    call's own."""
    def plain(*args):
        want = pairing.pairing_check_gt_plain(*args)
        compare(torch, f"K4 GT values at {[tuple(a.shape) for a in args]}",
                pairing.pairing_check_gt(*args), want)
        return want[0]
    return plain


def k4_tampered(torch, pairing, args, tag: str) -> None:
    """One K4 call with the P of its first pair that is not degenerate
    negated: that pair's group, which held, must fail (its product is
    divided by e(P, Q)^2, not one for such a pair).  Verdicts and GT values
    byte-identical to the plain version's."""
    from consensus_specs_tpu_torch.ops.torch_bls import limbs as L
    t0 = time.perf_counter()
    live = (~args[2]).nonzero().flatten().tolist()
    check(bool(live), f"K4: {tag} has no pair that is not degenerate")
    i = live[0]
    g = int((args[3] <= i).sum()) - 1
    check(bool(pairing.pairing_check(*args)[g]), f"K4: {tag}: group {g} must hold untouched")
    p = args[0].clone()
    p[i, 1] = L.pack(L.neg_mod(L.unpack(args[0][i, 1])))
    bad = (p,) + tuple(args[1:])
    got = pairing.pairing_check_gt(*bad)
    compare(torch, f"K4 GT values, {tag} with one pair tampered", got,
            pairing.pairing_check_gt_plain(*bad))
    check(not bool(got[0][g]), f"K4: {tag} with one pair tampered must fail")
    print(f"check pairing_check ({tag}, pair {i}'s P negated): its group fails; verdicts and "
          f"GT values byte-identical to the plain version's ({time.perf_counter() - t0:.1f} s)")


def k4_shapes(torch, card, pairing, calls: dict) -> list:
    """K4 at each path's call: pairs, groups, the launches counted on that
    path's run, device ms per call queued ahead, the bound. ``calls`` maps
    a path to (its recorded K4 arguments, its K4 launch count)."""
    from consensus_specs_tpu_torch.ops.torch_bls import limbs as L
    out = []
    for path, (args, launches) in calls.items():
        fq = pairing.pairing_check_fq_products(*args)
        out.append({"path": path, "pairs": int(args[0].shape[0]),
                    "groups": int(args[3].shape[0]) - 1,
                    "ms": queued_ms(torch, lambda: pairing.pairing_check(*args), 5),
                    "bound_ms": fq * L.IMAD_PER_FQ_MUL / IMAD_PER_S * 1e3,
                    "launches": launches})
    print("time pairing_check at every path's shape (ms per call queued ahead; bound): "
          + "; ".join(f"{v['path']} ({v['pairs']} pairs, {v['groups']} groups) {v['ms']:.3f} "
                      f"({v['bound_ms']:.5f})" for v in out) + f" on {card}")
    return out


def first_by_points(rec, counts: dict) -> dict:
    """{N: (the first K7 call's arguments at N points, the path's calls at
    N)} of a recorder of ``expand_windows``; ``counts``: its ``by_shape``
    when the path's run ended."""
    out = {}
    for args, _ in rec.calls:
        n = int(args[0].shape[0])
        if n not in out:
            out[n] = (args, counts.get(str(rec.shapes(args)), 0))
    return out


def field_elements(tag: bytes, n: int, r: int) -> list:
    """n seeded canonical field elements."""
    raw = hashlib.shake_256(SEED + tag).digest(32 * n)
    return [int.from_bytes(raw[32 * i:32 * (i + 1)], "big") % r for i in range(n)]


def plain_ms(torch, fn) -> float:
    """Wall ms of one call of a plain version on the card (it issues many
    small kernels; one call is long enough to time on the host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def slice3_kernel_checks(torch, dev, msm_sizes=MSM_SIZES, fft_sizes=FFT_SIZES,
                         skew_sizes=K8_SKEW_POINTS, k7_sizes=K7_SIZES) -> dict:
    """Phase 7: K7, K8 and K9 byte-identical to their plain versions on the
    card and to the oracle on small seeded inputs; returns the largest
    word difference of each (0)."""
    from consensus_specs_tpu_torch.ops import fr_fft, msm
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import kzg_7594 as K7
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR, G1Point
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    r = K.BLS_MODULUS
    base, step = (G1_GENERATOR.mult(v) for v in field_elements(b"msm-points", 2, r))
    err = {"expand_windows": 0, "g1_msm": 0, "fr_fft": 0}
    for n in msm_sizes:
        # a repeated point, P beside -P, the point at infinity, then a walk
        pts = [base, base, -base, G1Point.inf(), step][:n]
        while len(pts) < n:
            pts.append(pts[-1] + step)
        scalars = ([0, 1, r - 1] + field_elements(b"msm-scalars" + bytes([n % 256]), n, r))[:n]
        aff, inf = (t.to(dev) for t in C.pack_g1(pts))
        win = msm.expand_windows(aff, inf)
        err["expand_windows"] = max(err["expand_windows"], compare(
            torch, f"K7 (N={n})", win, msm.expand_windows_plain(aff, inf)))
        sc = msm.scalar_words(scalars).to(dev)
        out = msm.msm_core(win, sc)
        err["g1_msm"] = max(err["g1_msm"], compare(torch, f"K8 (N={n})", out,
                                                   msm.msm_core_plain(win, sc)))
        got = C.unpack_g1(out[0][None], out[1].reshape(1))[0]
        check(got == K._pippenger_msm(pts, scalars), f"K8 differs from the oracle at N={n}")
    t0 = time.perf_counter()
    for n in k7_sizes:
        pts = [base, G1Point.inf(), step, -step, G1Point.inf()][:n]
        while len(pts) < n:
            pts.append(pts[-1] + step)
        aff, inf = (t.to(dev) for t in C.pack_g1(pts))
        err["expand_windows"] = max(err["expand_windows"], compare(
            torch, f"K7 (N={n})", msm.expand_windows(aff, inf), msm.expand_windows_plain(aff, inf)))
    print(f"kernel checks: K7 at N = {', '.join(map(str, k7_sizes))} (a partial warp of teams; "
          f"points at infinity, P beside -P) byte-identical to its plain version on the card "
          f"({time.perf_counter() - t0:.1f} s)")
    for n in fft_sizes:
        roots = list(K.compute_roots_of_unity(n))
        n_rows = 2 if n > 256 else 4
        vals = field_elements(b"fft" + n.to_bytes(4, "little"), n * n_rows, r)
        rows = [vals[i * n:(i + 1) * n] for i in range(n_rows)]
        rows[0][:3] = [0, 1, r - 1][:n]
        with CallRecorder(torch, fr_fft, "fr_fft") as k9:
            fwd = fr_fft.fft_batch(rows, roots, device=dev)
            inv = fr_fft.fft_batch(rows, roots, inv=True, device=dev)
            back = fr_fft.fft_batch(fwd, roots, inv=True, device=dev)
        check(fwd == [K7.fft_field(row, roots) for row in rows], f"K9 forward at n={n}")
        check(inv == [K7.fft_field(row, roots, inv=True) for row in rows], f"K9 inverse at n={n}")
        check(back == rows, f"K9 round trip at n={n}")
        err["fr_fft"] = max(err["fr_fft"], k9.hold(fr_fft.fr_fft_plain))
    err["fr_fft"] = max(err["fr_fft"], k9_edges(torch, dev))
    err["g1_msm"] = max(err["g1_msm"], k8_skew_checks(torch, dev, skew_sizes))
    print(f"kernel checks (small inputs): K7 and K8 at N = {', '.join(map(str, msm_sizes))} "
          f"(scalars 0, 1, r - 1; a repeated base, P with -P, the point at infinity) and "
          f"K9 at n = {', '.join(map(str, fft_sizes))} (forward, inverse, round trip) "
          f"byte-identical to their plain versions on the card, to the oracle's "
          f"Pippenger and to the host fft_field (tolerance 0: integer outputs)")
    return err


K9_EDGE_LOGS = range(1, 15)         # n = 2 .. 2^14
K9_EDGE_ROWS = range(1, 8)
K9_CHUNKED = (1 << 17, 1 << 18)     # rows wider than a cluster: chunks and cross-chunk stages


def k9_edges(torch, dev) -> int:
    """K9 byte-identical to its plain version on the card at every n from 2
    to 2^14 with 1 to 7 rows, forward and inverse (the wrapper's plans:
    one CTA a row up to clusters of 16), and at 2^17 and 2^18 points (one
    row: the chunks and the stages that cross them).  Returns the largest
    word difference (0)."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import fr_fft
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err, plans, counted = 0, set(), {}
    t0 = time.perf_counter()
    for log in K9_EDGE_LOGS:
        n = 1 << log
        for inv in (False, True):
            vals, tw = k9_inputs(torch, dev, max(K9_EDGE_ROWS), n, inv, b"edge")
            for rows in K9_EDGE_ROWS:
                v = vals[:rows].contiguous()
                plans.add(fr_fft.launch_plan(n, rows, sms))
                err = max(err, compare(torch, f"K9 (n={n}, rows={rows}, inverse={inv})",
                                       fr_fft.fr_fft(v, tw), fr_fft.fr_fft_plain(v, tw)))
    for n in K9_CHUNKED:
        for inv in (False, True):
            vals, tw = k9_inputs(torch, dev, 1, n, inv, b"chunked")
            plan = fr_fft.launch_plan(n, 1, sms)
            plans.add(plan)
            _build.launches["fr_fft"] = 0
            got = fr_fft.fr_fft(vals, tw)
            counted[n] = _build.launches["fr_fft"]
            _build.launches["fr_fft"] = 0
            want = (n // (plan[0] * plan[1])).bit_length()      # 1 + log2(n / chunk)
            check(counted[n] == fr_fft.launches_per_call(n, plan) == want,
                  f"K9 at n = {n}: {counted[n]} launches counted, {want} made")
            err = max(err, compare(torch, f"K9 (n={n}, rows=1, inverse={inv})",
                                   got, fr_fft.fr_fft_plain(vals, tw)))
    torch.cuda.synchronize()
    print(f"kernel checks: K9 at every n = 2 .. 2^14 with 1-7 rows and at n = 2^17, 2^18 "
          f"(chunks and the stages across them), forward and inverse, byte-identical to its "
          f"plain version on the card; plans (cluster, tile, threads) "
          f"{sorted(plans)}; CUDA launches counted a call at n = 2^17, 2^18: {counted} "
          f"({time.perf_counter() - t0:.1f} s)")
    return err


def k8_skew_checks(torch, dev, sizes=K8_SKEW_POINTS) -> int:
    """K8 on skewed digits over a seeded progression P_i = A + i B: every
    scalar the byte 0x5A repeated (all 32 N lanes in one bucket) and a
    single live lane at N = sizes[0], uniform scalars with every other
    point at infinity at N = sizes[1]; each held against the plain
    version on the card and against the oracle, which sums the finite
    points' terms as [sum k_i] A + [sum i k_i] B.  Returns the largest
    word difference (0)."""
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import msm
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    r = K.BLS_MODULUS
    a, b = (G1_GENERATOR.mult(v) for v in field_elements(b"msm-skew", 2, r))
    pts, p = [], a
    for _ in range(max(sizes)):
        pts.append(p)
        p = p + b
    small, big = sizes
    uniform = field_elements(b"msm-skew-scalars", big, r)
    cases = (("every scalar one repeated byte", small,
              [int.from_bytes(bytes([0x5A]) * 32, "little")] * small, False),
             ("a single live lane", small, [0] * (small - 1) + [1 << 200], False),
             ("every other point at infinity", big, uniform, True))
    err, t0 = 0, time.perf_counter()
    for name, n, scalars, halved in cases:
        aff, inf = C.pack_g1(pts[:n])
        if halved:
            inf[::2] = True
        win = msm.expand_windows(aff.to(dev), inf.to(dev))
        sc = msm.scalar_words(scalars).to(dev)
        out = msm.msm_core(win, sc)
        err = max(err, compare(torch, f"K8 ({name}, N={n})", out, msm.msm_core_plain(win, sc)))
        live = range(1, n, 2) if halved else range(n)
        want = a.mult(sum(scalars[i] for i in live) % r) + b.mult(
            sum(i * scalars[i] for i in live) % r)
        check(C.unpack_g1(out[0][None], out[1].reshape(1))[0] == want,
              f"K8 differs from the oracle ({name}, N={n})")
    print(f"kernel checks: K8 with every scalar one repeated byte and with a single live lane "
          f"at N = {small}, every other point at infinity at N = {big}, byte-identical to its "
          f"plain version on the card and equal to the oracle ({time.perf_counter() - t0:.1f} s)")
    return err


def k8_hold_every(torch, rec) -> int:
    """Every K8 call that ``rec`` kept, held against ``msm_core_plain`` at
    the cost of two plain calls per window table.  The first call on each
    table is replayed as it was; all of them are held at once through
    seeded 64-bit weights w_k: the table's points have order r, so
    sum_k [w_k] K8(T, s_k) must equal msm_core_plain(T, sum_k w_k s_k mod r).
    The oracle sums the left side on the host.  A wrong output passes only
    if the seeded weights happen to cancel its error.  Returns the largest
    word difference of the replays (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import msm
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1Point
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    r = K.BLS_MODULUS
    groups = []                         # [(table, [(scalars, outputs)])]
    for args, out in rec.calls:
        win, sc = args
        group = next((g for g in groups if g[0].shape == win.shape and torch.equal(g[0], win)),
                     None)
        if group is None:
            group = (win, [])
            groups.append(group)
        group[1].append((sc, out))
    err = 0
    for gi, (win, calls) in enumerate(groups):
        sc0, out0 = calls[0]
        err = max(err, compare(torch, f"K8 at {tuple(win.shape)}", out0,
                               as_tuple(msm.msm_core_plain(win, sc0))))
        weights = field_elements(b"k8-weights" + bytes([gi]), len(calls), 1 << 64)
        comb = [0] * win.shape[1]
        want = G1Point.inf()
        for w, (sc, out) in zip(weights, calls):
            raw = np.ascontiguousarray(sc.cpu().numpy()).view("<u4")
            for i, row in enumerate(raw):
                comb[i] += w * int.from_bytes(row.tobytes(), "little")
            want = want + C.unpack_g1(out[0][None].cpu(), out[1].reshape(1).cpu())[0].mult(w)
        aff, inf = msm.msm_core_plain(win, msm.scalar_words([c % r for c in comb]).to(win.device))
        check(C.unpack_g1(aff[None].cpu(), inf.reshape(1).cpu())[0] == want,
              f"K8: the weighted sum of its {len(calls)} calls on the table "
              f"{tuple(win.shape)} differs from the plain version's MSM of the weighted scalars")
    return err


def blob_phase(torch, dev, card, setup, n_blobs=BLOBS) -> dict:
    """Phase 8: a block's blobs.  Commit to and prove each blob, verify
    the batch (one K4 launch), reject an altered blob, match one
    commitment and one proof with the oracle's Pippenger, hold the first
    K7 and K4 call of every shape and every K8 call (:func:`k8_hold_every`)
    against their plain versions, time."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls_torch, msm
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops.torch_bls import pairing
    from consensus_specs_tpu_torch.utils import bls
    r, width = K.BLS_MODULUS, setup.FIELD_ELEMENTS_PER_BLOB
    blobs = [b"".join(x.to_bytes(32, "big") for x in
                      field_elements(b"blob" + bytes([i]), width, r)) for i in range(n_blobs)]
    t0 = time.perf_counter()
    for p in setup.g1_lagrange_brp:
        K._to_g1(p)
    t_dec = time.perf_counter() - t0
    print(f"blobs: {n_blobs} of {width} field elements (MAX_BLOBS_PER_BLOCK, "
          f"FIELD_ELEMENTS_PER_BLOB); set-up: Lagrange basis decompression {t_dec:.2f} s "
          f"(host, once per process)")

    bls.use_torch(dev)
    commit_ms, prove_ms, cs, proofs = [], [], [], []
    with CallRecorder(torch, msm, "expand_windows", first_of_shape=True) as k7, \
            CallRecorder(torch, msm, "msm_core") as k8, \
            CallRecorder(torch, bls_torch, "pairing_check", first_of_shape=True) as k4:
        _build.reset_launches()
        for b in blobs:
            t0 = time.perf_counter()
            cs.append(K.blob_to_kzg_commitment(b, setup))
            t1 = time.perf_counter()
            proofs.append(K.compute_blob_kzg_proof(b, cs[-1], setup))
            t2 = time.perf_counter()
            commit_ms.append((t1 - t0) * 1e3)
            prove_ms.append((t2 - t1) * 1e3)
        before = dict(_build.launches)
        clock = StageClock(sync=torch.cuda.synchronize)
        for mod, name in ((msm, "expand_windows"), (msm, "msm_core"), (bls_torch, "pairing_check")):
            clock.wrap(mod, name)
        host = StageClock()
        for name in VERIFY_HOST_STAGES:
            host.wrap(K, name)
        t0 = time.perf_counter()
        ok = K.verify_blob_kzg_proof_batch(blobs, cs, proofs, setup)
        verify_ms = (time.perf_counter() - t0) * 1e3
        host.restore()
        clock.restore()
        launches = dict(_build.launches)
        k7_counts = dict(k7.by_shape)
        check(ok is True, "the block's blob batch must verify")
        check(launches["pairing_check"] - before["pairing_check"] == 1,
              f"the batch verify must make exactly one K4 launch: {launches}")
        check(all(launches[k] > 0 for k in ("expand_windows", "g1_msm", "pairing_check")),
              f"a kernel of the blob path was not launched: {launches}")
        altered, off = list(blobs), 32 * (width // 2)
        x = int.from_bytes(blobs[-1][off:off + 32], "big")
        altered[-1] = blobs[-1][:off] + ((x + 1) % r).to_bytes(32, "big") + blobs[-1][off + 32:]
        check(K.verify_blob_kzg_proof_batch(altered, cs, proofs, setup) is False,
              "the batch with one blob element changed must fail")
    device_ms = sum(clock.ms.values())
    print(f"blob path: {n_blobs} commitments and {n_blobs} proofs, the batch verifies "
          f"with one K4 launch, one changed element fails it; launches {launches}")

    bls.use_py()
    t0 = time.perf_counter()
    c_or = K.blob_to_kzg_commitment(blobs[0], setup)
    t1 = time.perf_counter()
    p_or = K.compute_blob_kzg_proof(blobs[0], c_or, setup)
    t2 = time.perf_counter()
    bls.use_torch(dev)
    check(c_or == cs[0], "the commitment differs from the oracle's Pippenger")
    check(p_or == proofs[0], "the proof differs from the oracle's Pippenger")
    print(f"oracle: blob 0's commitment and proof equal the host Pippenger's "
          f"({t1 - t0:.2f} s and {t2 - t1:.2f} s of python)")

    err7 = k7.hold(msm.expand_windows_plain)
    err8 = k8_hold_every(torch, k8)
    err4 = k4.hold(k4_gt_plain(torch, pairing))
    k4_tampered(torch, pairing, k4.calls[0][0], "the blob batch verify")
    print(f"check expand_windows, g1_msm, pairing_check (verdicts and GT values): equal to "
          f"their plain versions, K7 and K4 at the first call of every shape, every K8 call "
          f"(the first on each window table replayed, all through a seeded weighted sum per "
          f"table) ({k7.count}, {k8.count} and {k4.count} calls; shapes "
          f"{sorted({str(k7.shapes(a)) for a, _ in k7.calls})}, "
          f"{sorted({str(k8.shapes(a)) for a, _ in k8.calls})})")
    print(f"time commit per blob (host included): {', '.join(f'{v:.2f}' for v in commit_ms)} "
          f"ms; prove per blob: {', '.join(f'{v:.2f}' for v in prove_ms)} ms on {card}")
    print(f"time verify_blob_kzg_proof_batch ({n_blobs} blobs): {verify_ms:.2f} ms = device "
          f"(kernel wrappers, synchronized) {device_ms:.2f} ("
          + ", ".join(f"{k} {v:.2f}" for k, v in clock.ms.items())
          + f") + host {verify_ms - device_ms:.2f} on {card}")
    print("verify_blob_kzg_proof_batch host stages (ms, wall clock): "
          + ", ".join(f"{k} {host.ms.get(k, 0.0):.2f}" for k in VERIFY_HOST_STAGES)
          + f"; rest of the host part {verify_ms - device_ms - sum(host.ms.values()):.2f} "
          f"on {card}")
    big7 = next(a for a, _ in k7.calls if a[0].shape[0] == width)
    big8 = next(a for a, _ in k8.calls if a[0].shape[1] == width)
    small8 = next(a for a, _ in k8.calls if a[0].shape[1] == n_blobs)
    return {"launches": launches, "err": {"expand_windows": err7, "g1_msm": err8,
                                          "pairing_check": err4},
            "k7": big7, "k8": big8, "k8_small": small8, "blobs": blobs, "cs": cs,
            "k7_calls": first_by_points(k7, k7_counts), "k4_call": k4.calls[0][0],
            "proofs": proofs,
            "held": {(r.name, str(r.shapes(a))) for r in (k7, k8) for a, _ in r.calls},
            "k4_launches": launches["pairing_check"] - before["pairing_check"],
            "commit_ms": commit_ms, "prove_ms": prove_ms, "verify_ms": verify_ms,
            "verify_device_ms": device_ms}


def peerdas_phase(torch, dev, card, setup, blobs, cs, n_cols=SAMPLED_COLUMNS) -> dict:
    """Phase 9: PeerDAS.  The blobs' cells, recovery from half of the
    columns (the same columns withheld from every blob: one group, 4
    batched FFTs on K9), cell proofs of ``n_cols`` columns per blob and
    their batch verify (one K4 launch), an altered cell rejected; every K9
    launch of the recovery held against the plain version; timings."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.das import kernels as D
    from consensus_specs_tpu_torch.ops import bls_torch, fr_fft, msm
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import kzg_7594 as K7
    from consensus_specs_tpu_torch.ops.torch_bls import pairing
    width = setup.FIELD_ELEMENTS_PER_BLOB
    n_cells = K7.cells_per_blob(setup)
    cell_bytes = lambda cell: b"".join(int(x).to_bytes(32, "big") for x in cell)
    t0 = time.perf_counter()
    cells = [K7.compute_cells(b, setup) for b in blobs]
    t_cells = time.perf_counter() - t0
    order = sorted(range(n_cells), key=lambda c: hashlib.sha256(SEED + b"col" + bytes([c])).digest())
    withheld = set(order[:n_cells // 2])
    keep = [c for c in range(n_cells) if c not in withheld]
    requests = [(keep, [cell_bytes(cl[c]) for c in keep]) for cl in cells]

    # -- stage 2: recovery ---------------------------------------------------
    host = StageClock()
    host.wrap(K7, "construct_vanishing_polynomial")
    host.wrap(K, "_batch_inverse")
    host.wrap(fr_fft, "fft_batch")
    dev_clock = StageClock(sync=torch.cuda.synchronize)
    dev_clock.wrap(fr_fft, "fr_fft")          # inside the recorder: kernel time only
    with CallRecorder(torch, fr_fft, "fr_fft") as k9:
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recovered = D.recover_cells_batch(requests, setup)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t0) * 1e3
        rec_launches = dict(_build.launches)
    dev_clock.restore()
    host.restore()
    check(all(rec == [x for cl in orig for x in cl] for rec, orig in zip(recovered, cells)),
          "the recovered data differ from the original extended cells")
    batches = host.calls.get("fft_batch", 0)
    check(rec_launches["fr_fft"] == batches == 4,
          f"recovery of one group makes 4 batched FFTs, one K9 launch each: {batches} "
          f"batches, {rec_launches['fr_fft']} launches")
    err9 = k9.hold(fr_fft.fr_fft_plain)
    k9_ms = dev_clock.ms["fr_fft"]
    fft_host = host.ms["fft_batch"] - k9_ms
    print(f"recovery: {len(blobs)} blobs from {len(keep)} of {n_cells} columns (the same "
          f"{len(withheld)} withheld from every blob: one group) equal to their extended "
          f"cells; {batches} batched FFTs, {rec_launches['fr_fft']} K9 launches at "
          f"{sorted({str(k9.shapes(a)) for a, _ in k9.calls})}, each equal to its plain "
          f"version; set-up: compute_cells {t_cells:.2f} s (host)")
    print(f"time recover_cells_batch: {recover_ms:.2f} ms = K9 (synchronized) {k9_ms:.2f} + "
          f"fft_batch host packing {fft_host:.2f} + vanishing polynomial "
          f"{host.ms['construct_vanishing_polynomial']:.2f} + batch inverse "
          f"{host.ms['_batch_inverse']:.2f} + rest (shifts, products, bit reversal) "
          f"{recover_ms - host.ms['fft_batch'] - host.ms['construct_vanishing_polynomial'] - host.ms['_batch_inverse']:.2f} on {card}")

    # -- stage 3: sampling ----------------------------------------------------
    cols = sorted(order[n_cells // 2:][:n_cols])
    with CallRecorder(torch, msm, "expand_windows", first_of_shape=True) as k7, \
            CallRecorder(torch, msm, "msm_core") as k8, \
            CallRecorder(torch, bls_torch, "pairing_check", first_of_shape=True) as k4:
        _build.reset_launches()
        phost = StageClock()
        for name in PROOF_HOST_STAGES:
            phost.wrap(K7, name)
        phost.wrap(K, "g1_lincomb")
        t0 = time.perf_counter()
        row_ids, col_ids, sampled, proofs = [], [], [], []
        for i, b in enumerate(blobs):
            coeff = K7.polynomial_eval_to_coeff(K.blob_to_polynomial(b, width), setup)
            for c in cols:
                proof, ys = K7.compute_kzg_proof_multi_impl(coeff, K7.coset_for_cell(c, setup),
                                                            setup)
                check(ys == cells[i][c], f"cell proof evaluations differ (blob {i}, column {c})")
                row_ids.append(i)
                col_ids.append(c)
                sampled.append(cell_bytes(cells[i][c]))
                proofs.append(proof)
        proofs_ms = (time.perf_counter() - t0) * 1e3
        phost.restore()
        before = dict(_build.launches)
        clock = StageClock(sync=torch.cuda.synchronize)
        for mod, name in ((msm, "expand_windows"), (msm, "msm_core"), (bls_torch, "pairing_check")):
            clock.wrap(mod, name)
        vhost = StageClock()
        for mod, name in ((K, "validate_kzg_g1"), (D, "_cell_fields"), (D, "batch_challenge"),
                          (K7, "fft_field"), (K, "_to_g1")):
            vhost.wrap(mod, name)
        t0 = time.perf_counter()
        ok = D.verify_cell_proof_batch(cs, row_ids, col_ids, sampled, proofs, setup)
        vcell_ms = (time.perf_counter() - t0) * 1e3
        vhost.restore()
        clock.restore()
        launches = dict(_build.launches)
        k7_counts = dict(k7.by_shape)
        check(ok is True, "the sampled cells must verify")
        check(launches["pairing_check"] - before["pairing_check"] == 1,
              f"the cell batch must make exactly one K4 launch: {launches}")
        check(all(launches[k] > 0 for k in ("expand_windows", "g1_msm", "pairing_check")),
              f"a kernel of the sampling path was not launched: {launches}")
        bad = list(sampled)
        x = int.from_bytes(bad[-1][64:96], "big")
        bad[-1] = bad[-1][:64] + ((x + 1) % K.BLS_MODULUS).to_bytes(32, "big") + bad[-1][96:]
        check(D.verify_cell_proof_batch(cs, row_ids, col_ids, bad, proofs, setup) is False,
              "the cell batch with one element changed must fail")
    err7 = k7.hold(msm.expand_windows_plain)
    t0 = time.perf_counter()
    err8 = k8_hold_every(torch, k8)
    t_hold8 = time.perf_counter() - t0
    err4 = k4.hold(k4_gt_plain(torch, pairing))
    n = len(proofs)
    print(f"sampling: {n} cell proofs ({len(cols)} columns x {len(blobs)} blobs) verify as "
          f"one batch with one K4 launch, one changed element fails it; launches {launches}; "
          f"the first K7/K4 call of every shape equal to its plain version (K4's GT values "
          f"too); every one of the "
          f"{k8.count} K8 calls held against its plain version (the first on each window "
          f"table replayed, all through a seeded weighted sum per table; "
          f"{sorted({str(k8.shapes(a)) for a, _ in k8.calls})}; {t_hold8:.1f} s)")
    print(f"time cell proofs: {proofs_ms:.2f} ms for {n} ({proofs_ms / n:.2f} each, host "
          f"polynomial work included); verify_cell_proof_batch: {vcell_ms:.2f} ms = device "
          f"(synchronized) {sum(clock.ms.values()):.2f} + host "
          f"{vcell_ms - sum(clock.ms.values()):.2f} on {card}")
    poly_ms = sum(phost.ms.get(k, 0.0) for k in PROOF_HOST_STAGES)
    print("cell proofs by stage (ms, wall clock): "
          + ", ".join(f"{k} {phost.ms.get(k, 0.0):.2f}" for k in PROOF_HOST_STAGES)
          + f" (polynomial work {poly_ms:.2f}); g1_lincomb {phost.ms['g1_lincomb']:.2f} "
          f"(decompression, packing, K7/K8); rest {proofs_ms - poly_ms - phost.ms['g1_lincomb']:.2f}"
          f" on {card}")
    print("verify_cell_proof_batch host stages (ms, wall clock): "
          + ", ".join(f"{k} {v:.2f}" for k, v in vhost.ms.items())
          + f"; rest of the host part "
          f"{vcell_ms - sum(clock.ms.values()) - sum(vhost.ms.values()):.2f} on {card}")
    k8_cell = next(a for a, _ in k8.calls if a[0].shape[1] == width - K7.FIELD_ELEMENTS_PER_CELL)
    total = {k: rec_launches[k] + launches[k] for k in launches}
    # phase 21 samples these columns of every blob and recovers blob 0 from
    # the kept half
    per_blob = len(cols)
    sampling = [(cols, sampled[i * per_blob:(i + 1) * per_blob],
                 proofs[i * per_blob:(i + 1) * per_blob]) for i in range(len(blobs))]
    return {"launches": total, "err": {"fr_fft": err9, "expand_windows": err7,
                                       "g1_msm": err8, "pairing_check": err4},
            "k9": k9.calls[0][0], "k8_cell": k8_cell, "recover_ms": recover_ms,
            "k7_calls": first_by_points(k7, k7_counts), "k4_call": k4.calls[0][0],
            "proofs": proofs, "sampling": sampling, "recover_request": requests[0],
            "extended": [x for cl in cells[0] for x in cl],
            "held": {(r.name, str(r.shapes(a))) for r in (k7, k8) for a, _ in r.calls},
            "k4_launches": launches["pairing_check"] - before["pairing_check"],
            "k9_path_ms": k9_ms, "k9_launches": rec_launches["fr_fft"], "k9_batches": batches,
            "proofs_ms": proofs_ms, "vcell_ms": vcell_ms}


def slice3_entries(torch, card, blob, das, err, launches) -> list:
    """The K7, K8 and K9 entries of the ``kernels`` line, timed at the
    path's shapes (K7 at the Lagrange basis, K8 at a commitment's MSM, K9
    at one stage of the recovery's batched FFT), with the other shapes
    of the path beside them."""
    from consensus_specs_tpu_torch.ops import fr_fft, msm
    from consensus_specs_tpu_torch.ops.torch_bls import fr as F
    from consensus_specs_tpu_torch.ops.torch_bls import limbs as L

    def fq_bound(products) -> float:
        return products * L.IMAD_PER_FQ_MUL / IMAD_PER_S * 1e3

    out = []

    def k7_bound(inf) -> tuple:
        ops = fq_bound(msm.expand_windows_fq_products(inf))
        byt = (96 + msm.N_WINDOWS * 144) * inf.shape[0] / HBM_BYTES_PER_S * 1e3
        return max(ops, byt), "operations" if ops >= byt else "bytes"

    pts, inf = blob["k7"]
    k7_ms = cuda_ms(torch, lambda: msm.expand_windows(pts, inf))
    k7_plain = plain_ms(torch, lambda: msm.expand_windows_plain(pts, inf))
    bound7, by7 = k7_bound(inf)
    shapes7 = {}
    for path, calls in (("blob", blob["k7_calls"]), ("sampling", das["k7_calls"])):
        for n, (args, count) in sorted(calls.items()):
            if n not in shapes7:
                ms = queued_ms(torch, lambda: msm.expand_windows(*args), 10)
                shapes7[n] = {"points": n, "ms": ms, "bound_ms": k7_bound(args[1])[0],
                              "launches": {}}
            shapes7[n]["launches"][path] = count
    out.append({"name": "expand_windows", "route": "cuda",
                "source": "consensus_specs_tpu_torch/csrc/msm.cu",
                "replaces": "consensus_specs_tpu/ops/jax_bls/msm.py:38",
                "launches": launches["expand_windows"], "max_abs_err": err["expand_windows"],
                "ms": k7_ms, "plain_ms": k7_plain, "bound_ms": bound7, "bound_by": by7,
                "library_ms": None, "points": int(pts.shape[0]),
                "shapes": [shapes7[n] for n in sorted(shapes7)]})
    print(f"time expand_windows at N={pts.shape[0]}: {k7_ms:.3f} ms (plain {k7_plain:.1f} ms, "
          f"bound {bound7:.5f} ms, {by7}) on {card}")
    print("time expand_windows at every launched shape (ms per call queued ahead; bound; "
          "launches by path): " + "; ".join(
              f"N={v['points']} {v['ms']:.4f} ({v['bound_ms']:.6f}; {v['launches']})"
              for v in shapes7.values()) + f" on {card}")
    k8 = {}
    for tag, (win, sc) in (("commit", blob["k8"]), ("cell", das["k8_cell"]),
                           ("verify", blob["k8_small"])):
        ms = cuda_ms(torch, lambda: msm.msm_core(win, sc))
        ops = fq_bound(msm.msm_core_fq_products(win, sc))
        byt = (win.numel() * 4 + sc.numel() * 4 + 97) / HBM_BYTES_PER_S * 1e3
        ladder = fq_bound(msm.msm_core_ladder_fq_products(win, sc))
        k8[tag] = (int(win.shape[1]), ms, max(ops, byt), "operations" if ops >= byt else "bytes",
                   ladder)
    stages = {tag: msm.msm_core_stage_ms(*args) for tag, args in
              (("commit", blob["k8"]), ("cell", das["k8_cell"]), ("verify", blob["k8_small"]))}
    win, sc = blob["k8"]
    k8_plain = plain_ms(torch, lambda: msm.msm_core_plain(win, sc))
    n, ms, bound, by, _ = k8["commit"]
    out.append({"name": "g1_msm", "route": "cuda", "source": "consensus_specs_tpu_torch/csrc/msm.cu",
                "replaces": "consensus_specs_tpu/ops/jax_bls/msm.py:48",
                "launches": launches["g1_msm"], "max_abs_err": err["g1_msm"], "ms": ms,
                "plain_ms": k8_plain, "bound_ms": bound, "bound_by": by, "library_ms": None,
                "points": n, "stages_ms": stages["commit"],
                "other_shapes": {t: {"points": v[0], "ms": v[1], "bound_ms": v[2],
                                     "stages_ms": stages[t]}
                                 for t, v in k8.items() if t != "commit"}})
    print("time g1_msm: " + "; ".join(f"{t} N={v[0]} {v[1]:.3f} ms (bound {v[2]:.5f} ms, {v[3]}; "
                                      f"one ladder per lane at that rate {v[4]:.5f} ms)"
                                      for t, v in k8.items())
          + f"; plain at N={n} {k8_plain:.1f} ms on {card}")
    for tag, st in stages.items():
        print(f"time g1_msm stages at the {tag} shape (ms per call, device, {st['launches']} "
              f"launches): " + ", ".join(f"{k} {st[k]:.5f}" for k in msm.STAGES) + f" on {card}")
    from consensus_specs_tpu_torch import _build
    vals, tw = das["k9"]
    rows, npts = vals.shape[0], vals.shape[1]
    # the launches of one batch, counted: the counter zeroed, one call, read
    _build.launches["fr_fft"] = 0
    fr_fft.fr_fft(vals, tw)
    torch.cuda.synchronize()
    per_batch = _build.launches["fr_fft"]
    _build.launches["fr_fft"] = 0
    plan = fr_fft.launch_plan(npts, rows, torch.cuda.get_device_properties(vals.device)
                              .multi_processor_count)
    check(per_batch == fr_fft.launches_per_call(npts, plan) == 1,
          f"K9: one launch a batch, but the timed call made {per_batch}")
    batch_ms = queued_ms(torch, lambda: fr_fft.fr_fft(vals, tw), 20)
    k9_plain = plain_ms(torch, lambda: fr_fft.fr_fft_plain(vals, tw))
    products9 = fr_fft.fr_fft_fr_products(rows, npts)
    ops9 = products9 * F.IMAD_PER_FR_MUL / IMAD_PER_S * 1e3
    bytes9 = fr_fft.fr_fft_bytes(rows, npts) / HBM_BYTES_PER_S * 1e3
    out.append({"name": "fr_fft", "route": "cuda",
                "source": "consensus_specs_tpu_torch/csrc/fr_fft.cu",
                "replaces": "consensus_specs_tpu/ops/jax_bls/fr_fft.py:211",
                "launches": launches["fr_fft"], "max_abs_err": err["fr_fft"],
                "ms": batch_ms, "ms_is_per": "FFT batch", "plain_ms": k9_plain,
                "bound_ms": max(ops9, bytes9),
                "bound_by": "operations" if ops9 >= bytes9 else "bytes", "library_ms": None,
                "rows": rows, "n": npts, "plan": list(plan), "launches_per_batch": per_batch,
                "fr_products": products9,
                "chain_fr_products": fr_fft.fr_fft_chain(npts),
                "launches_per_recovery": das["k9_launches"], "batches_per_recovery":
                das["k9_batches"], "recovery_k9_synchronized_ms": das["k9_path_ms"]})
    print(f"time fr_fft per FFT batch at ({rows}, {npts}): {batch_ms:.4f} ms queued ahead "
          f"({per_batch} launch a batch, {das['k9_launches']} in the recovery's "
          f"{das['k9_batches']} batches; plan (cluster, tile, threads) {plan}; chain floor "
          f"{fr_fft.fr_fft_chain(npts)} dependent Fr products; plain "
          f"{k9_plain:.1f} ms, bound {max(ops9, bytes9):.6f} ms: operations {ops9:.6f} "
          f"({products9} Fr products by twiddles other than 1), "
          f"bytes {bytes9:.6f}) on {card}")
    return out


# ---------------------------------------------------------------------------
# slice 4: a mainnet phase0 epoch transition
# ---------------------------------------------------------------------------

EPOCH_SLOT = 32 * 7 - 1     # the next slot crosses into epoch 7
REDUCED_VALIDATORS = 4096   # the registry at which the spec loops still finish
QUIET_VALIDATORS = 1 << 18  # the not-leaking runs of phases 10 and 14 (a depth cut)
EPOCH_KERNELS = ("phase0_deltas", "effective_balance", "slashings")
EPOCH_REPLACES = {
    "phase0_deltas": "consensus_specs_tpu/ops/epoch_kernels.py:205",
    "effective_balance": "consensus_specs_tpu/ops/epoch_kernels.py:240",
    "slashings": "consensus_specs_tpu/ops/epoch_kernels.py:252",
    "altair_deltas": "consensus_specs_tpu/ops/epoch_kernels.py:169",
    "inactivity_updates": "consensus_specs_tpu/ops/epoch_kernels.py:192",
}
SUB_TRANSITIONS = ("process_rewards_and_penalties", "process_registry_updates",
                   "process_slashings", "process_effective_balance_updates")
# what one epoch transition on the card must show, per fork: the kernels
# it launches once each, the mesh kernels and their launches, the
# engine's sub-transitions, every host/card crossing (and the commits),
# and the spec helper that builds the attester sets.  On the mesh path
# the masks, sums and maxima are made on the card from the registry's
# epoch columns: each goes up once, and the registry updates send their
# written lanes (the smoke's ejections) up in one copy and scatter them
# into the card copies; on phase0 the attester masks (python sets) and
# the inclusion entries go up once and the inclusion keys come down
# once; on Altair no mask crosses.
_COPIES = {"h2d.balances": 1, "d2h.balances": 1, "h2d.eff": 1, "d2h.eff": 1, "h2d.act": 1,
           "h2d.sl": 1, "h2d.aee": 1, "h2d.ext": 1, "h2d.wd": 1, "h2d.registry_lanes": 1}
EPOCH_PATHS = {
    "phase0": {"kernels": EPOCH_KERNELS,
               "mesh": {"epoch_reduce": 3, "incl_scan": 1, "registry_scan": 1},
               "subs": SUB_TRANSITIONS,
               "copies": dict(_COPIES, **{"h2d.masks": 1, "h2d.incl_idx": 1,
                                          "h2d.incl_keys": 1, "d2h.incl_keys": 1,
                                          "h2d.incl_rewards": 1}),
               "commits": 1, "sets": "get_unslashed_attesting_indices",
               "k18": lambda n: [-(-n // 4)]},                  # balances
    "altair": {"kernels": ("inactivity_updates", "altair_deltas", "effective_balance",
                           "slashings"),
               "mesh": {"epoch_reduce": 4, "incl_scan": 0, "registry_scan": 1},
               "subs": ("process_inactivity_updates",) + SUB_TRANSITIONS,
               "copies": dict(_COPIES, **{"h2d.inactivity_scores": 1,
                                          "d2h.inactivity_scores": 1,
                                          "h2d.participation_previous": 1}),
               "commits": 2, "sets": "get_unslashed_participating_indices",
               # balances, inactivity scores, the new current participation
               "k18": lambda n: [-(-n // 4), -(-n // 4), -(-n // 32)]},
}
EPOCH_PATHS["capella"] = EPOCH_PATHS["deneb"] = EPOCH_PATHS["altair"]


def epoch_plain(ek) -> dict:
    return {"phase0_deltas": ek.phase0_deltas_plain,
            "effective_balance": ek.effective_balance_plain,
            "slashings": ek.slashings_plain,
            "altair_deltas": ek.altair_deltas_plain,
            "inactivity_updates": ek.inactivity_updates_plain}


def epoch_kernel_checks(torch, dev, n_lanes: int) -> int:
    """K10-K12 byte-identical to their plain versions on the card, on
    seeded columns with the edge values (zero balances, penalties above
    balance plus reward, balances at the hysteresis thresholds, lane
    products just under 2^63), at 1, 1000 and ``n_lanes`` lanes, leaking
    and not.  Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    gwei, err = 10**9, 0
    for n in (1, 1000, n_lanes):
        rng = np.random.default_rng(n)
        bal = rng.integers(0, 40 * gwei, n, dtype=np.int64)
        eff = rng.integers(0, 33, n, dtype=np.int64) * gwei
        incl = rng.integers(0, 2**25, n, dtype=np.int64)
        elig, target = rng.random(n) < 0.8, rng.random(n) < 0.1
        att = rng.random((3, n)) < 0.6
        k = min(n, 8)
        bal[:k] = 0
        eff[:k] = 32 * gwei
        elig[:k], att[:, :k], incl[:k], target[:k] = True, False, 0, True
        if n > 16:
            eff[8:12] = 16 * gwei
            bal[8:10] = 16 * gwei - gwei // 4          # at the downward threshold
            bal[10:12] = 16 * gwei + 5 * gwei // 4     # at the upward threshold
            bal[12] = 2**63 - 1 - 2**25                # balance + reward just under 2^63
        t = {name: torch.from_numpy(a).to(dev) for name, a in (
            ("bal", bal), ("eff", eff), ("incl", incl), ("elig", elig), ("target", target),
            ("att", att))}
        total = max(gwei, int(eff.sum()))
        for leak in (False, True):
            s = ek.Phase0Scalars(64, int(np.sqrt(total)), 4,
                                 tuple(max(1, int(eff[a].sum()) // gwei) for a in att),
                                 total // gwei, leak, 8, 5 if leak else 1, 2**26)
            args = (t["eff"], t["incl"], t["bal"], t["elig"], t["att"], s)
            err = max(err, compare(torch, f"K10 (n={n}, leak={leak})", ek.phase0_deltas(*args),
                                   ek.phase0_deltas_plain(*args)))
        args = (t["bal"], t["eff"], gwei, gwei // 4, 5 * gwei // 4, 32 * gwei)
        err = max(err, compare(torch, f"K11 (n={n})", ek.effective_balance(*args),
                               ek.effective_balance_plain(*args)))
        args = (t["eff"], t["bal"], t["target"], gwei, total // 2, total)
        err = max(err, compare(torch, f"K12 (n={n})", ek.slashings(*args),
                               ek.slashings_plain(*args)))
    torch.cuda.synchronize()
    print(f"kernel checks (small inputs): K10-K12 at n = 1, 1000, {n_lanes} (zero balances, "
          f"penalties above balance plus reward, hysteresis thresholds, lane sums just under "
          f"2^63; leaking and not) byte-identical to their plain versions on the card "
          f"(tolerance 0: integers)")
    return max(err, k12_edges(torch, dev, n_lanes))


# K12's (increment, total balance) sets: an increment of 1 with the total
# at it; powers of two; a prime increment; mainnet's increment with the
# total at it (the engines' clamp) and at 2^20 validators of 32 ETH
K12_DIVISORS = {"ones": (1, 1), "powers of two": (2**30, 2**45),
                "a prime": (1000000007, 1000000007 * 1000003 + 11),
                "total at the increment": (10**9, 10**9),
                "mainnet": (10**9, 2**20 * 32 * 10**9)}
K12_TARGETS = ("none", "all", "every fourth")


def k12_edges(torch, dev, n_lanes: int) -> int:
    """K12 byte-identical to its plain version on the card at n = 1, 3, 4, 5,
    7, 1000 and ``n_lanes`` + 3 lanes, for each divisor set of
    :data:`K12_DIVISORS`, each target mask of :data:`K12_TARGETS` and the
    adjusted balance at 0, a third of the total and the total, with lane
    0's (eff // increment) x adjusted at the guard's limit and balances that
    clamp, on columns that start on their storage (4-lane groups and a
    tail) and one lane into it (off 16 bytes: every lane one at a time).
    Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    limit, err, calls = 2**63 - 1, 0, 0
    t0 = time.perf_counter()
    for n in (1, 3, 4, 5, 7, 1000, n_lanes + 3):
        m = n + 1
        for tag, (inc, total) in K12_DIVISORS.items():
            rng = np.random.default_rng(n * 12 + len(tag))
            eff0 = rng.integers(0, 33, m, dtype=np.int64) * 10**9
            bal = rng.integers(0, 40 * 10**9, m, dtype=np.int64)
            bal[1:4] = [0, 1, 10**9][:min(3, m - 1)]
            for adjusted in (0, total // 3, total):
                # lane 0 (and lane 1, the first of the one-lane-in layout) at the guard's limit
                top = min(limit // max(1, adjusted), 2048 * 10**9 // inc) * inc
                eff = np.minimum(eff0, top)
                eff[:2] = top
                masks = {"none": np.zeros(m, bool), "all": np.ones(m, bool),
                         "every fourth": np.arange(m) % 4 == 0}
                for pattern in K12_TARGETS:
                    cols = [torch.from_numpy(a).to(dev) for a in (eff, bal, masks[pattern])]
                    for lay, args in (("on its storage", [c[:n] for c in cols]),
                                      ("one lane in", [c[1:] for c in cols])):
                        args += [inc, adjusted, total]
                        err = max(err, compare(
                            torch, f"K12 (n={n}, divisors {tag}, adjusted {adjusted}, targets "
                                   f"{pattern}, {lay})", ek.slashings(*args),
                            ek.slashings_plain(*args)))
                        calls += 1
    torch.cuda.synchronize()
    print(f"kernel checks: K12 at n = 1, 3, 4, 5, 7, 1000, {n_lanes + 3}, divisors "
          f"{K12_DIVISORS}, adjusted 0, a third of the total and the total, targets "
          f"{K12_TARGETS}, (eff // increment) x adjusted at the guard's limit, columns on their "
          f"storage and one lane in ({calls} calls) byte-identical to its plain version on the "
          f"card (tolerance 0: integers; {time.perf_counter() - t0:.1f} s)")
    return err


def epoch_scatter(spec, np, n: int, seed: int):
    """The registry edges of ``tests/test_epoch_vectorized.py``'s
    ``_scatter_registry_edges(preserve_active=True)``, seeded, written
    into the (n, 121) record bytes (pubkey 0:48, credentials 48:80,
    effective balance 80:88, slashed 88, eligibility 89:97, activation
    97:105, exit 105:113, withdrawable 113:121) and the balances."""
    current, prev = EPOCH_SLOT // 32, EPOCH_SLOT // 32 - 1
    target = current + spec.EPOCHS_PER_SLASHINGS_VECTOR // 2
    step = spec.EFFECTIVE_BALANCE_INCREMENT // spec.HYSTERESIS_QUOTIENT

    def scatter(rec, bal):
        rng = np.random.default_rng(seed)
        roll = rng.random(n)
        u64 = lambda lo: rec[:, lo:lo + 8].copy().view("<u8").reshape(n)  # noqa: E731
        slashed = roll < 0.16
        rec[slashed, 88] = 1
        wd = u64(113)
        draw = lambda lo, hi: rng.integers(lo, hi, n).astype(np.uint64)  # noqa: E731
        wd[roll < 0.08] = np.uint64(prev + 2) + draw(0, 4)[roll < 0.08]
        wd[(roll >= 0.08) & (roll < 0.12)] = target
        wd[(roll >= 0.12) & (roll < 0.16)] = prev + 1
        exiting = (roll >= 0.16) & (roll < 0.22)
        ext = u64(105)
        ext[exiting] = np.uint64(current) + draw(1, 4)[exiting]
        wd[exiting] = ext[exiting] + draw(1, 5)[exiting]
        rec[:, 105:113] = ext.astype("<u8").view(np.uint8).reshape(n, 8)
        rec[:, 113:121] = wd.astype("<u8").view(np.uint8).reshape(n, 8)
        eff = u64(80)
        eff[(roll >= 0.22) & (roll < 0.28)] = spec.config.EJECTION_BALANCE
        rec[:, 80:88] = eff.astype("<u8").view(np.uint8).reshape(n, 8)
        moved = rng.random(n) < 0.6
        delta = rng.integers(-3, 4, n) * step
        bal[moved] = np.maximum(0, bal[moved].astype(np.int64) + delta[moved])
        scatter.slashed_total = int(eff[slashed].sum())
    return scatter


def epoch_state(spec, ssz, np, pks, n: int, seed: int):
    """A mainnet phase0 ``BeaconState`` of ``n`` validators at slot
    ``EPOCH_SLOT`` with the registry edges scattered, the slashed
    validators' effective balances in ``state.slashings`` (as
    ``slash_validator`` accounts them) and every committee of epoch 5 in
    ``previous_epoch_attestations`` (all bits set, inclusion delays 1-4,
    a seeded tenth with a wrong target root and another tenth with a
    wrong head root); finalized at epoch 4, not leaking."""
    scatter = epoch_scatter(spec, np, n, seed)
    state = build_registry_state(spec, ssz, np, pks, n, scatter)
    rng = np.random.default_rng(seed + 1)
    roots = [hashlib.sha256(SEED + b"root" + i.to_bytes(4, "little")).digest()
             for i in range(EPOCH_SLOT + 1)]
    hist = spec.SLOTS_PER_HISTORICAL_ROOT
    state.slot = EPOCH_SLOT
    state.block_roots = [roots[i] if i <= EPOCH_SLOT else b"\x00" * 32 for i in range(hist)]
    state.state_roots = [hashlib.sha256(roots[i]).digest() if i <= EPOCH_SLOT else b"\x00" * 32
                         for i in range(hist)]
    state.latest_block_header = spec.BeaconBlockHeader(
        slot=EPOCH_SLOT, proposer_index=7, parent_root=roots[EPOCH_SLOT - 1],
        body_root=ssz.hash_tree_root(spec.BeaconBlockBody()))
    state.slashings[3] = scatter.slashed_total
    fin = spec.Checkpoint(epoch=4, root=roots[4 * 32])
    state.finalized_checkpoint = fin
    state.previous_justified_checkpoint = fin
    state.current_justified_checkpoint = fin
    state.justification_bits = [True, False, False, False]
    # every validator is active at epoch 5 (get_committee_count_per_slot)
    per_slot = max(1, min(spec.MAX_COMMITTEES_PER_SLOT,
                          n // spec.SLOTS_PER_EPOCH // spec.TARGET_COMMITTEE_SIZE))
    size = n // (32 * per_slot)
    prev_start = 5 * 32
    atts = []
    for k in range(32 * per_slot):
        slot, index = prev_start + k // per_slot, k % per_slot
        roll = rng.random()
        target_root = roots[prev_start] if roll >= 0.1 else roots[prev_start + 1]
        head = roots[slot] if roll >= 0.2 else roots[slot - 1]
        data = spec.AttestationData(slot=slot, index=index, beacon_block_root=head,
                                    source=fin, target=spec.Checkpoint(epoch=5, root=target_root))
        atts.append(spec.PendingAttestation(
            aggregation_bits=[True] * size, data=data,
            inclusion_delay=int(rng.integers(1, 5)), proposer_index=int(rng.integers(0, n))))
    state.previous_epoch_attestations = atts
    return state


def leaking(spec, state, fork=True):
    """A copy of ``state`` (``state`` itself without ``fork``: a caller
    that holds it no longer) finalized at epoch 0: finality delay 5 > 4,
    an inactivity leak."""
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    out = state_arrays.fork_state(state) if fork else state
    out.finalized_checkpoint = spec.Checkpoint(epoch=0, root=state.block_roots[0])
    return out


def epoch_run(torch, dev, card, spec, base, tag: str, inspect=None, fork=True) -> dict:
    """One epoch transition of a copy of ``base`` (``base`` itself without
    ``fork``: a caller that holds it no longer) through ``process_slots``
    on the card, every epoch-kernel call recorded (K10-K12 on phase0,
    K14, K13, K11 and K12 on Altair; K15-K17 and the commit's K18 on the
    mesh path) and held against its plain version; the post-state root on
    K5 and K18 against the hashlib root of a fresh deserialization.
    ``inspect(post_state)``: its result is kept as ``inspected`` (the
    post-state itself is not kept)."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    from consensus_specs_tpu_torch.utils import ssz
    from consensus_specs_tpu_torch.utils.ssz import merkle

    t0 = time.perf_counter()
    state = state_arrays.fork_state(base) if fork else base
    t_copy = time.perf_counter() - t0
    in_leak = bool(spec.is_in_inactivity_leak(state))
    path = EPOCH_PATHS[spec.fork]
    kernels, subs = path["kernels"], path["subs"]
    ek.use_vectorized(dev)
    host, card_clock = StageClock(), StageClock(sync=torch.cuda.synchronize)
    for name in ("process_justification_and_finalization", "process_epoch", "process_slot",
                 path["sets"]):
        host.wrap(spec, name)
    for name in kernels:
        card_clock.wrap(ek, name)
    for name in ("upload", "download"):
        card_clock.wrap(state_arrays, name)
    host.wrap(state_arrays, "_write_u64_list")
    # each sub-transition's wall ms and the part of it spent in the card
    # clock's synchronized wrappers (kernels and host/card copies)
    split = {}

    def splitting(name, fn):
        def timed(st):
            c0, t0 = sum(card_clock.ms.values()), time.perf_counter()
            try:
                return fn(st)
            finally:
                split[name] = ((time.perf_counter() - t0) * 1e3,
                               sum(card_clock.ms.values()) - c0)
        return timed
    for name in subs:
        setattr(spec, name, splitting(name, getattr(spec, name)))
    recorders = [CallRecorder(torch, ek, name) for name in kernels]
    recorders += [CallRecorder(torch, me, name, canon=mesh_canon(torch, name))
                  for name in MESH_KERNELS]
    recorders.append(CallRecorder(torch, mm, "merkle_levels"))
    ek.reset_stats()
    me.reset_stats()
    state_arrays.reset_stats()
    _build.reset_launches()
    torch.cuda.synchronize()
    for r in recorders:
        r.__enter__()
    t0 = time.perf_counter()
    spec.process_slots(state, EPOCH_SLOT + 1)
    torch.cuda.synchronize()
    t_slots = (time.perf_counter() - t0) * 1e3
    for r in reversed(recorders):
        r.__exit__()
    launches = {k: _build.launches[k] for k in kernels + MESH_KERNELS + ("merkle_levels",)}
    for name in subs:
        delattr(spec, name)
    card_clock.restore()
    host.restore()
    stats, mesh_stats, copies = ek.stats(), me.stats(), state_arrays.stats()
    check(all(launches[k] == 1 for k in kernels),
          f"{tag}: each kernel of the epoch must launch once: {launches}")
    check(all(launches[k] == v for k, v in path["mesh"].items()),
          f"{tag}: mesh launches {launches}, expected {path['mesh']}")
    k18_check(f"{tag}: the commit", recorders[-1].calls, launches["merkle_levels"],
              path["k18"](len(base.validators)))
    check(stats == {"vectorized": len(subs), "loop": 0, "guard": 0},
          f"{tag}: expected {len(subs)} vectorized commits, 0 loop runs, 0 guard trips: "
          f"{stats}")
    check(mesh_stats == {"commits": len(subs), "off": 0, "floor": 0, "guard": 0, "overflow": 0},
          f"{tag}: expected {len(subs)} mesh commits and no decline: {mesh_stats}")
    crossings = {k: v for k, v in copies.items() if k.startswith(("h2d.", "d2h."))}
    check(crossings == path["copies"], f"{tag}: crossings {crossings}, expected {path['copies']}")
    check(copies.get("commits") == path["commits"],
          f"{tag}: commits = {copies.get('commits')}, expected {path['commits']}: {copies}")

    merkle.reset_stats()
    t0 = time.perf_counter()
    root = bytes(ssz.hash_tree_root(state))
    torch.cuda.synchronize()
    t_root = (time.perf_counter() - t0) * 1e3
    root_stats = merkle.stats()

    plain = dict(epoch_plain(ek), **mesh_plain())
    hashlib_roots.submit(f"the {tag} epoch's post-state (K5 and K18)", spec, ssz, state, root)
    err = {r.name: r.hold(plain[r.name]) for r in recorders}

    ms, cm = host.ms, card_clock.ms
    kernel_ms = {k: cm.get(k, 0.0) for k in kernels}
    copy_ms = cm.get("upload", 0.0) + cm.get("download", 0.0)
    other_ms = (ms["process_epoch"] - ms["process_justification_and_finalization"]
                - sum(v[0] for v in split.values()))
    print(f"epoch {tag}: {len(base.validators)} validators, leak {in_leak}: "
          f"process_slots {t_slots:.2f} ms = process_slot root {ms['process_slot']:.2f} + "
          f"process_epoch {ms['process_epoch']:.2f} + scope commit and the rest "
          f"{t_slots - ms['process_slot'] - ms['process_epoch']:.2f}; in process_epoch: "
          f"justification and finalization {ms['process_justification_and_finalization']:.2f}, "
          + ", ".join(f"{n.replace('process_', '')} {split[n][0]:.2f} (card {split[n][1]:.2f}, "
                      f"host {split[n][0] - split[n][1]:.2f})" for n in subs)
          + f", other sub-transitions {other_ms:.2f}; card time = synchronized kernel wrappers ("
          + ", ".join(f"{k} {v:.3f}" for k, v in kernel_ms.items())
          + f") and host/card copies {copy_ms:.2f} ({crossings}); commit (_write_u64_list) "
          f"{ms.get('_write_u64_list', 0.0):.2f}; {path['sets']} "
          f"{ms.get(path['sets'], 0.0):.2f} (all calls) on {card}")
    print(f"epoch {tag}: launches {launches}, engine {stats}, mesh engine {mesh_stats}, copies "
          f"{copies}; post-state root "
          f"{root.hex()} on K5 and K18 in {t_root:.2f} ms (pairs by K5 {root_stats['pairs_batched']}, by "
          f"hashlib {root_stats['pairs_hashlib']}; the hashlib root: a worker's); set-up: a "
          f"fork {t_copy:.2f} s; every call of {list(kernels) + list(MESH_KERNELS)} and K18 held "
          f"against its plain version")
    sub_ms = {n: split[n] for n in subs}
    inspected = inspect(state) if inspect is not None else None
    return {"launches": launches, "err": err, "calls": {r.name: r.calls for r in recorders},
            "kwargs": {r.name: r.kwargs for r in recorders}, "mesh_stats": mesh_stats,
            "slots_ms": t_slots, "epoch_ms": ms["process_epoch"], "sub_ms": sub_ms,
            "kernel_ms": kernel_ms, "copy_ms": copy_ms, "root_ms": t_root,
            "in_leak": in_leak, "inspected": inspected}


def reduced_epoch_leg(torch, dev, spec, base, n: int, post=None) -> None:
    """The same construction at ``n`` validators (``base``): the port's
    spec loops, its columnar engine (below the mesh floor) and its mesh
    engine (``use_mesh``) on the card give identical post-state roots, not
    leaking and leaking.  ``post(pre, post_state)`` checks each run's
    post-state further."""
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    from consensus_specs_tpu_torch.parallel import mesh_state
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    from consensus_specs_tpu_torch.utils import ssz
    t0 = time.perf_counter()
    subs = len(EPOCH_PATHS[spec.fork]["subs"])
    out = []
    for pre in (base, leaking(spec, base)):
        roots = {}
        for engine in ("loops", "vectorized", "mesh"):
            s = state_arrays.fork_state(pre)
            if engine == "loops":
                ek.use_loops()
            else:
                ek.use_vectorized(dev)
            (mesh_state.use_mesh if engine == "mesh" else mesh_state.use_fallback)()
            ek.reset_stats()
            me.reset_stats()
            spec.process_slots(s, EPOCH_SLOT + 1)
            st = ek.stats()
            want = {"vectorized": 0, "loop": subs, "guard": 0} if engine == "loops" \
                else {"vectorized": subs, "loop": 0, "guard": 0}
            check(st == want, f"reduced leg ({engine}): engine counters {st}")
            check((me.stats()["commits"] == subs) == (engine == "mesh"),
                  f"reduced leg ({engine}): mesh engine counters {me.stats()}")
            roots[engine] = bytes(ssz.hash_tree_root(s))
            if post is not None:
                post(pre, s)
        check(roots["loops"] == roots["vectorized"] == roots["mesh"],
              f"reduced leg: loops, the columnar engine and the mesh engine differ at {n} "
              f"validators")
        out.append(bool(spec.is_in_inactivity_leak(pre)))
    ek.use_vectorized(dev)
    mesh_state.use_auto()
    print(f"reduced leg ({spec.fork}): {n} validators, leak {out}: the spec loops, the "
          f"columnar engine and the mesh engine on the card give identical post-state roots "
          f"({time.perf_counter() - t0:.2f} s)")


def epoch_phase(torch, dev, card, pks, n_validators: int) -> dict:
    """Phase 10: a mainnet phase0 epoch transition of ``n_validators``
    through ``process_slots`` on the card, not leaking and leaking; the
    reduced leg; K10-K12 timed beside their bounds and plain versions."""
    import numpy as np
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    from consensus_specs_tpu_torch.utils import bls, ssz

    spec = build_spec("phase0", "mainnet")
    sha256.install_merkle_hasher(dev)
    bls.bls_active = False              # epoch processing verifies no signature
    err = epoch_kernel_checks(torch, dev, n_validators)

    t0 = time.perf_counter()
    base = epoch_state(spec, ssz, np, pks, n_validators, seed=4)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = bytes(ssz.hash_tree_root(base))
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    state_arrays.reset_stats()
    t0 = time.perf_counter()
    store = state_arrays.of(base)
    store.registry()
    store.balances()
    t_extract = (time.perf_counter() - t0) * 1e3
    print(f"epoch state: {n_validators} validators at slot {EPOCH_SLOT}, "
          f"{len(base.previous_epoch_attestations)} pending attestations of epoch 5 "
          f"(committees of {len(base.previous_epoch_attestations[0].aggregation_bits)}); "
          f"set-up: build {t_build:.2f} s, cold root {t_cold:.3f} s on K5 ({cold.hex()[:16]}), "
          f"column extraction {t_extract:.2f} ms (registry and balances, once per lineage: "
          f"the runs' forks share them) on {card}")
    quiet = None
    if n_validators > QUIET_VALIDATORS:
        # a depth cut for the time limit (PERF.md §4): the not-leaking run
        # on a registry of 2^18 built the same way; the leaking run, whose
        # calls the K10-K12 rows time, keeps the whole registry
        t0 = time.perf_counter()
        quiet = epoch_state(spec, ssz, np, pks, QUIET_VALIDATORS, seed=4)
        ssz.hash_tree_root(quiet)
        print(f"epoch: the not-leaking run at {QUIET_VALIDATORS} validators (a depth cut); its "
              f"state built and hashed in {time.perf_counter() - t0:.2f} s")
    runs = {"not_leaking": epoch_run(torch, dev, card, spec, base if quiet is None else quiet,
                                      "not leaking")}
    runs["leaking"] = epoch_run(torch, dev, card, spec, leaking(spec, base), "leaking")
    check(not runs["not_leaking"]["in_leak"] and runs["leaking"]["in_leak"],
          "the two runs must be one not leaking and one leaking")
    n = REDUCED_VALIDATORS
    reduced_epoch_leg(torch, dev, spec, epoch_state(spec, ssz, np, pks, n, seed=n), n)
    bls.bls_active = True
    # phase 14 upgrades the untouched states to Altair (``quiet``: the
    # not-leaking run's own registry, None where it ran on ``base``)
    return {"runs": runs, "err": err, "extract_ms": t_extract, "cold_s": t_cold, "base": base,
            "quiet": quiet}


def epoch_bound_counts(ek, name, args, in_leak) -> tuple:
    """(bytes, operations) that this call's data needs (``ek.*_bytes``,
    ``ek.*_ops``)."""
    if name == "phase0_deltas":
        return ek.phase0_deltas_bytes(args[3]), ek.phase0_deltas_ops(args[3], in_leak)
    if name == "effective_balance":
        n = args[0].numel()
        return ek.effective_balance_bytes(n), ek.effective_balance_ops(n)
    if name == "slashings":
        return ek.slashings_bytes(args[2]), ek.slashings_ops(args[2])
    if name == "altair_deltas":
        return ek.altair_deltas_bytes(args[4], args[3], args[5]), ek.altair_deltas_ops(args[4])
    return ek.inactivity_updates_bytes(args[2]), ek.inactivity_updates_ops(args[2])


def epoch_entries(torch, card, phase, names=EPOCH_KERNELS) -> list:
    """The ``kernels`` line's entries of the epoch kernels ``names``, timed
    per launch with CUDA events at the leaking run's arguments, beside
    their bounds (bytes and operations this run's data needs) and their
    plain versions on the card."""
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    run = phase["runs"]["leaking"]
    plain = epoch_plain(ek)
    out = []
    for name in names:
        args = run["calls"][name][0][0]
        fn = getattr(ek, name)
        ms = queued_ms(torch, lambda: fn(*args))
        back_ms = cuda_ms(torch, lambda: fn(*args), reps=20)
        p_ms = plain_ms(torch, lambda: plain[name](*args))
        nbytes, ops = epoch_bound_counts(ek, name, args, run["in_leak"])
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        launches = max(r["launches"][name] for r in phase["runs"].values())
        err = max(phase["err"], max(r["err"][name] for r in phase["runs"].values()))
        # the not-leaking run's call too, beside its own bound
        quiet = phase["runs"]["not_leaking"]["calls"][name][0][0]
        q_ms = queued_ms(torch, lambda: fn(*quiet))
        q_bytes, q_ops = epoch_bound_counts(ek, name, quiet, False)
        q_bound = max(q_bytes / HBM_BYTES_PER_S, q_ops / INT32_OPS_PER_S) * 1e3
        out.append({"name": name, "route": "cuda",
                    "source": "consensus_specs_tpu_torch/csrc/epoch.cu",
                    "replaces": EPOCH_REPLACES[name], "launches": launches, "max_abs_err": err,
                    "ms": ms, "plain_ms": p_ms, "bound_ms": max(b_ms, o_ms),
                    "bound_by": "bytes" if b_ms >= o_ms else "operations", "library_ms": None,
                    "lanes": int(args[0].numel()), "bytes": nbytes, "ops": ops,
                    "back_to_back_ms": back_ms, "not_leaking_ms": q_ms,
                    "not_leaking_bound_ms": q_bound, "not_leaking_lanes": int(quiet[0].numel())})
        print(f"time {name} at {args[0].numel()} lanes: {ms:.4f} ms per launch queued ahead "
              f"({back_ms:.4f} ms per wrapper call back to back, host launch included; plain on the "
              f"card {p_ms:.3f} ms, bound {max(b_ms, o_ms):.5f} ms: bytes {nbytes} -> "
              f"{b_ms:.5f} ms, operations {ops} -> {o_ms:.5f} ms); at the not-leaking run's call "
              f"({quiet[0].numel()} lanes) {q_ms:.4f} ms queued ahead (bound {q_bound:.5f} ms); "
              f"launches per epoch "
              f"{launches} on {card}")
    return out


# ---------------------------------------------------------------------------
# slice 5: the Altair runtime (a mainnet Altair block with its sync
# aggregate, an Altair epoch transition)
# ---------------------------------------------------------------------------

ALTAIR_EPOCH_KERNELS = ("inactivity_updates", "altair_deltas")


def altair_kernel_checks(torch, dev, n_lanes: int) -> int:
    """Phase 12: K13 and K14 byte-identical to their plain versions on the
    card, at 1, 1000 and ``n_lanes`` lanes, leaking and not, on seeded
    columns with the edges: every combination of the three flag bits,
    eligible and not, active (unslashed) and not, zero balances,
    penalties that clamp at the first, a middle and the last pair, scores
    at 0, 1 and the recovery rate, and lane products just under 2^63
    (``eff x score``, ``base x weight x participating increments``,
    balance plus the rewards).  Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    gwei, err, limit = 10**9, 0, 2**63 - 1
    bias, rec, denom = 4, 16, 4 * 50331648
    for n in (1, 1000, n_lanes):
        rng = np.random.default_rng(n + 5)
        eff = rng.integers(0, 33, n, dtype=np.int64) * gwei
        bal = rng.integers(0, 40 * gwei, n, dtype=np.int64)
        scores = rng.integers(0, 100, n, dtype=np.int64)
        part = rng.integers(0, 8, n).astype(np.uint8)
        elig, active = rng.random(n) < 0.8, rng.random(n) < 0.85
        k = min(n, 8)
        part[:k] = np.arange(k)                      # every flag combination
        elig[:k], active[:k], bal[:k], eff[:k] = True, True, 0, 32 * gwei
        scores[:3] = [0, 1, rec][:min(3, n)]
        if n > 16:
            eff[8:14] = 32 * gwei
            elig[8:14], active[8:14] = True, True
            bal[8], part[8] = 1, 0                   # clamps at the first pair (source)
            bal[9], part[9], scores[9] = 1, 5, 0     # at the middle pair (target), head after
            bal[10], part[10], scores[10] = 10 * gwei, 5, 2**27   # at the last (inactivity)
            scores[11], part[11] = limit // (32 * gwei), 0        # eff x score just under 2^63
            active[12], elig[13] = False, False      # slashed or inactive; not eligible
        brpi = 64 * gwei // int(np.sqrt(max(gwei, int(eff.sum()))))
        br_max = 32 * brpi
        pinc = (max(1, n // 3), limit // (br_max * 26), max(1, n // 4))   # target's just under
        active_inc = max(1, int(eff.sum()) // gwei)
        reward_bound = sum(br_max * w * p // (active_inc * 64) for w, p in zip((14, 26, 14), pinc))
        if n > 16:
            bal[14], elig[14], active[14], part[14] = limit - reward_bound, True, True, 7
        t = {name: torch.from_numpy(a).to(dev) for name, a in (
            ("eff", eff), ("bal", bal), ("scores", scores), ("part", part), ("elig", elig),
            ("active", active))}
        for leak in (False, True):
            s = ek.AltairScalars(gwei, brpi, (14, 26, 14), pinc, active_inc, 64, leak, denom)
            args = (t["eff"], t["bal"], t["scores"], t["part"], t["elig"], t["active"], s)
            err = max(err, compare(torch, f"K13 (n={n}, leak={leak})", ek.altair_deltas(*args),
                                   ek.altair_deltas_plain(*args)))
            args = (t["scores"], t["part"], t["elig"], t["active"], bias, rec, leak)
            err = max(err, compare(torch, f"K14 (n={n}, leak={leak})",
                                   ek.inactivity_updates(*args), ek.inactivity_updates_plain(*args)))
        if n > 16:
            # outside a leak the head reward after the middle pair's clamp
            # survives: summing the pairs before one clamp would give 0
            s = s._replace(in_leak=False)
            got = ek.altair_deltas(t["eff"], t["bal"], t["scores"], t["part"], t["elig"],
                                   t["active"], s).cpu().numpy()
            check(got[8] == 0 and got[10] == 0 and got[9] > 0,
                  f"K13: the clamp lanes give {got[8:11].tolist()}")
    torch.cuda.synchronize()
    print(f"kernel checks (small inputs): K13 and K14 at n = 1, 1000, {n_lanes} (every flag "
          f"combination, eligible and not, active and not, zero balances, clamps at the first, "
          f"the middle and the last pair, scores 0, 1 and {rec}, lane products just under "
          f"2^63; leaking and not) byte-identical to their plain versions on the card "
          f"(tolerance 0: integers)")
    return max(err, k13_edges(torch, dev, n_lanes))


# K13's divisor sets (increment, weight denominator, active increments,
# inactivity denominator): every divisor 1; powers of two; primes (the
# reward denominator is then a prime times a prime)
K13_DIVISORS = {"ones": (1, 1, 1, 1), "powers of two": (2**30, 64, 2**20, 2**26),
                "primes": (1000000007, 61, 1000003, 2**31 - 1)}


def k13_edges(torch, dev, n_lanes: int) -> int:
    """K13 byte-identical to its plain version on the card at n = 1, 3, 4, 5,
    7, 1000 and ``n_lanes`` + 3 lanes, leaking and not, for each divisor set
    of :data:`K13_DIVISORS`, with the lane products at the guards' limit
    (base x weight x participating increments, eff x score and balance
    plus the rewards just under 2^63), on columns that start on their
    storage (4-lane groups and a tail) and one lane into it (off 16 bytes:
    every lane one at a time).  Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    gwei, limit, err, calls = 10**9, 2**63 - 1, 0, 0
    t0 = time.perf_counter()
    for n in (1, 3, 4, 5, 7, 1000, n_lanes + 3):
        for tag, (inc, wd, active_inc, inact) in K13_DIVISORS.items():
            rng = np.random.default_rng(n * 13 + len(tag))
            m = n + 1
            eff = rng.integers(0, 32 * gwei + 1, m, dtype=np.int64)
            eff[:2] = 32 * gwei
            brpi = 64 * gwei // int(np.sqrt(max(gwei, int(eff.sum()))))
            br_max = (32 * gwei // inc) * brpi
            # the target's at the limit: its product and the three rewards below 2^63
            cap = limit // (br_max * 14 * 4)              # the source's and head's far below
            p0, p2 = max(1, min(n // 3, cap)), max(1, min(n // 4, cap))
            pinc = (p0, (limit - br_max * 14 * (p0 + p2)) // (br_max * 26), p2)
            reward_bound = sum(br_max * w * p // (active_inc * wd)
                               for w, p in zip((14, 26, 14), pinc))
            # every balance plus its rewards below 2^63 (the engine's guard),
            # lane 1's (every flag, the largest base) at the limit
            bal = np.minimum(rng.integers(0, 40 * gwei, m, dtype=np.int64), limit - reward_bound)
            bal[1] = limit - reward_bound
            scores = rng.integers(0, 100, m, dtype=np.int64)
            scores[2 % m] = limit // (32 * gwei)           # eff x score just under 2^63
            eff[2 % m] = 32 * gwei
            part = rng.integers(0, 8, m).astype(np.uint8)
            part[1] = 7
            part[2 % m] = 0
            elig, active = rng.random(m) < 0.8, rng.random(m) < 0.85
            elig[:3], active[:3] = True, True
            cols = [torch.from_numpy(a).to(dev) for a in (eff, bal, scores, part, elig, active)]
            layouts = {"on its storage": [c[:n] for c in cols],
                       "one lane in": [c[1:] for c in cols]}
            for leak in (False, True):
                s = ek.AltairScalars(inc, brpi, (14, 26, 14), pinc, active_inc, wd, leak, inact)
                for lay, args in layouts.items():
                    err = max(err, compare(torch, f"K13 (n={n}, divisors {tag}, leak={leak}, "
                                                  f"{lay})", ek.altair_deltas(*args, s),
                                           ek.altair_deltas_plain(*args, s)))
                    calls += 1
    torch.cuda.synchronize()
    print(f"kernel checks: K13 at n = 1, 3, 4, 5, 7, 1000, {n_lanes + 3}, divisors "
          f"{K13_DIVISORS}, lane products at the guards' limit, columns on their storage and one "
          f"lane in, leaking and not ({calls} calls) byte-identical to its plain "
          f"version on the card (tolerance 0: integers; {time.perf_counter() - t0:.1f} s)")
    return err


def altair_epoch_state(spec, ssz, np, pre, seed: int):
    """Phase 14's state: ``upgrade_to_altair`` of phase 10's phase0 state
    (``translate_participation`` gives the previous epoch's flags from
    its 2048 pending attestations), with seeded inactivity scores (30% of
    the lanes at 1-100, one in a thousand at 2^26-2^27, the scale of a
    months-long leak) and seeded current-epoch flags, both written
    packed."""
    state = spec.upgrade_to_altair(pre)
    n = len(state.validators)
    rng = np.random.default_rng(seed)
    roll = rng.random(n)
    scores = np.where(roll < 0.3, rng.integers(1, 101, n), 0).astype(np.uint64)
    big = roll < 0.001
    scores[big] = rng.integers(2**26, 2**27, n).astype(np.uint64)[big]
    state.inactivity_scores = ssz.basic_sequence_from_column(type(state.inactivity_scores),
                                                             scores)
    state.current_epoch_participation = ssz.basic_sequence_from_column(
        type(state.current_epoch_participation), rng.integers(0, 8, n).astype(np.uint8))
    return state


def signed_body(spec, dry, sks, pks, proposer) -> dict:
    """The signed parts of the Altair-family blocks of phases 13 and 17
    on ``dry`` (the pre-state at ``BLOCK_SLOT``), signed under its fork
    version: the attestations of the committees of slots 1 and 2 (every
    bit set, each signed with the sum of its members' secret keys), the
    randao reveal, and the current sync committee's aggregate of the
    previous slot's block root with a seeded ~1/16 of its members
    abstaining."""
    import numpy as np
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as O
    from consensus_specs_tpu_torch.ops.bls12_381.fields import R_ORDER

    def sk_of(v):
        return sks[v % len(sks)]

    t0 = time.perf_counter()
    committees = {(s, c): spec.get_beacon_committee(dry, s, c)
                  for s in (1, 2)
                  for c in range(int(spec.get_committee_count_per_slot(dry, 0)))}
    t_comm = time.perf_counter() - t0
    att_domain = spec.get_domain(dry, spec.DOMAIN_BEACON_ATTESTER, 0)
    t0 = time.perf_counter()
    atts = []
    for (s, c), members in committees.items():
        data = spec.AttestationData(
            slot=s, index=c, beacon_block_root=spec.get_block_root_at_slot(dry, s),
            source=dry.current_justified_checkpoint,
            target=spec.Checkpoint(epoch=0, root=spec.get_block_root(dry, 0)))
        sk = sum(sk_of(v) for v in members) % R_ORDER
        atts.append(spec.Attestation(
            aggregation_bits=[True] * len(members), data=data,
            signature=O.Sign(sk, spec.compute_signing_root(data, att_domain))))
    randao = O.Sign(sk_of(proposer), spec.compute_signing_root(
        spec.uint64(0), spec.get_domain(dry, spec.DOMAIN_RANDAO)))
    bits = (np.random.default_rng(13).random(SYNC) >= 1 / 16).tolist()
    sk_of_pk = dict(zip(pks, sks))
    members = [bytes(pk) for pk in dry.current_sync_committee.pubkeys]
    sync_root = spec.compute_signing_root(
        spec.get_block_root_at_slot(dry, BLOCK_SLOT - 1),
        spec.get_domain(dry, spec.DOMAIN_SYNC_COMMITTEE, 0))
    sync_sk = sum(sk_of_pk[pk] for pk, b in zip(members, bits) if b) % R_ORDER
    sync = spec.SyncAggregate(sync_committee_bits=bits,
                              sync_committee_signature=O.Sign(sync_sk, sync_root))
    return {"atts": atts, "randao": randao, "sync": sync, "bits": bits,
            "committees": committees,
            "n_keys": sum(len(m) for m in committees.values()) + sum(bits) + 2,
            "comm_s": t_comm, "sign_s": time.perf_counter() - t0}


def proposer_signer(spec, dry, sks, proposer):
    """A function signing a block message as ``proposer`` on ``dry``."""
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as O
    domain = spec.get_domain(dry, spec.DOMAIN_BEACON_PROPOSER)

    def signed(msg):
        sig = O.Sign(sks[proposer % len(sks)], spec.compute_signing_root(msg, domain))
        return spec.SignedBeaconBlock(message=msg, signature=sig)
    return signed


def card_transition(torch, spec, state, signed_block, stages, within=None, copy=True,
                    run=None) -> dict:
    """``state_transition`` of a copy of ``state`` on the card in a batch
    scope of its own, the verify memo cleared, every K1-K4 call and the
    first K5 call of every row count recorded, the ``stages`` (spec
    methods), the flush and the G2 decompression timed.  ``within``: a
    call made in the same scope before the transition (Deneb's data
    availability check, as ``on_block`` composes the two); without
    ``copy``, ``state`` itself is transitioned (a caller that holds it no
    longer).  ``run``: a call made in the scope instead of the two (fork
    choice's ``on_block``; the post-state is then the caller's to find).
    Returns the
    post-state, the batch, the launches, the recorders, the stage ms and
    the total ms."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls_torch, sha256
    from consensus_specs_tpu_torch.utils import bls
    clock = StageClock()
    post = None if run is not None else state.copy() if copy else state
    for name in stages:
        clock.wrap(spec, name)
    clock.wrap(bls.DeferredBatch, "flush")
    clock.wrap(bls_torch, "_decompress_g2")
    bls.clear_verify_memo()
    recorders = [CallRecorder(torch, bls_torch, k) for k in KERNELS]
    recorders.append(CallRecorder(torch, sha256, "hash64", first_of_shape=True))
    torch.cuda.synchronize()
    for r in recorders:
        r.__enter__()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        with bls.scoped_batch(bls.DeferredBatch()) as batch:
            if run is not None:
                run()
            else:
                if within is not None:
                    within()
                spec.state_transition(post, signed_block)
        torch.cuda.synchronize()
    finally:
        for r in reversed(recorders):
            r.__exit__()
        clock.restore()
    return {"post": post, "batch": batch, "launches": dict(_build.launches),
            "recorders": recorders, "ms": clock.ms,
            "total_ms": (time.perf_counter() - t0) * 1e3}


def hold_new_shapes(torch, recorders, held: set, tag: str) -> dict:
    """Hold the recorded K1-K5 (and K7, K8) calls against their plain
    versions (K4's GT values too), but for those at a (kernel, argument
    shapes) that an earlier phase held (``held``); returns {kernel: largest
    word difference}."""
    from consensus_specs_tpu_torch.ops import msm, sha256
    from consensus_specs_tpu_torch.ops.torch_bls import htc, pairing, points
    plain = {"g1_aggregate_scale": points.g1_aggregate_scale_plain,
             "g2_scale_sum": points.g2_scale_sum_plain, "hash_to_g2": htc.hash_to_g2_plain,
             "pairing_check": k4_gt_plain(torch, pairing), "hash64": sha256.hash64_plain,
             "expand_windows": msm.expand_windows_plain, "msm_core": msm.msm_core_plain}
    skipped = {}
    for r in recorders:
        keep = [i for i, (a, _) in enumerate(r.calls) if (r.name, str(r.shapes(a))) not in held]
        skipped[r.name] = len(r.calls) - len(keep)
        r.calls = [r.calls[i] for i in keep]
        r.kwargs = [r.kwargs[i] for i in keep]
    err = {r.name: r.hold(plain[r.name]) for r in recorders}
    print(f"{tag}: every recorded call of {[r.name for r in recorders]} (K5, and the recorders "
          f"made with first_of_shape: the first of every shape; K4's GT values too) at a shape "
          f"no earlier phase held, held against its plain version "
          f"({ {r.name: len(r.calls) for r in recorders} } held of "
          f"{ {r.name: r.count for r in recorders} } calls; recorded at shapes held before: "
          f"{skipped})")
    return err


def hold_msm_by_shape(torch, k7, k8, held: set, tag: str) -> dict:
    """Every K7 and K8 call that ``k7`` and ``k8`` kept at a shape no
    earlier phase held (``held``), held against the plain versions at the
    cost of two plain calls a shape: the first call of each shape is
    replayed as it was; K7's calls of a shape are held at once by the
    plain version of their points concatenated (each point's windows are
    its own: the outputs concatenated must equal it word for word); K8's
    calls of a shape through seeded 64-bit weights w_k over their tables
    concatenated (every table point has order r, so sum_k [w_k] K8(T_k,
    s_k) must equal the plain MSM of T_1 | ... | T_m with the scalars
    w_k s_k mod r; the oracle sums the left side).  A wrong K8 output
    passes only if the weights cancel its error.  Returns {kernel: the
    largest word difference} (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import msm
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1Point
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    err, by_shape = {"expand_windows": 0, "msm_core": 0}, {}
    for r in (k7, k8):
        for args, out in r.calls:
            key = (r.name, str(r.shapes(args)))
            if key not in held:
                by_shape.setdefault(key, []).append((args, out))
    for (name, shape), calls in by_shape.items():
        args0, out0 = calls[0]
        plain = msm.expand_windows_plain if name == "expand_windows" else msm.msm_core_plain
        err[name] = max(err[name], compare(torch, f"{name} at {shape}", out0,
                                           as_tuple(plain(*args0))))
        if len(calls) == 1:
            continue
        if name == "expand_windows":
            pts = torch.cat([a[0] for a, _ in calls])
            inf = torch.cat([a[1] for a, _ in calls])
            got = torch.cat([o[0] for _, o in calls], dim=1)
            err[name] = max(err[name], compare(
                torch, f"{name}: its {len(calls)} calls at {shape} concatenated", (got,),
                as_tuple(msm.expand_windows_plain(pts, inf))))
            continue
        weights = field_elements(b"k8-shape" + shape.encode(), len(calls), 1 << 64)
        scalars, want = [], G1Point.inf()
        for w, (a, o) in zip(weights, calls):
            raw = np.ascontiguousarray(a[1].cpu().numpy()).view("<u4")
            scalars += [w * int.from_bytes(row.tobytes(), "little") % K.BLS_MODULUS
                        for row in raw]
            want = want + C.unpack_g1(o[0][None].cpu(), o[1].reshape(1).cpu())[0].mult(w)
        win = torch.cat([a[0] for a, _ in calls], dim=1)
        aff, inf = msm.msm_core_plain(win, msm.scalar_words(scalars).to(win.device))
        check(C.unpack_g1(aff[None].cpu(), inf.reshape(1).cpu())[0] == want,
              f"K8: the weighted sum of its {len(calls)} calls at {shape} differs from the plain "
              f"MSM of the concatenated tables")
    print(f"{tag}: every K7 and K8 call at a shape no earlier phase held, held against its plain "
          f"version ({ {k: len(v) for k, v in by_shape.items()} } calls by shape: the first of "
          f"each replayed, K7's concatenated, K8's through seeded weights)")
    return err


def altair_block_phase(torch, dev, card, sks, pks, pre, held: set) -> dict:
    """Phase 13: a mainnet Altair block through ``state_transition`` on
    ``dev``: the state is ``upgrade_to_altair`` of phase 6's phase0 state
    (2^20 validators); the block carries 128 attestations, the current
    sync committee's aggregate with a seeded ~1/16 of its bits off, the
    proposer signature and the randao reveal (131 RLC items).  ``held``:
    (kernel, argument shapes) that phase 4 held against the plain
    versions; the transition's K1-K4 calls at other shapes are held
    here."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.parallel import mesh_merkle
    from consensus_specs_tpu_torch.utils import bls, ssz

    spec = build_spec("altair", "mainnet")
    bls.use_torch(dev)
    sha256.install_merkle_hasher(dev)
    up = StageClock()
    for name in ("translate_participation", "get_next_sync_committee"):
        up.wrap(spec, name)
    # the new lists' trees are built where they are made: the upgrade's
    # packed lists and translate_participation's commit go through K18
    _build.reset_launches()
    with CallRecorder(torch, mesh_merkle, "merkle_levels") as spans:
        t0 = time.perf_counter()
        state = spec.upgrade_to_altair(pre)
        t_up = time.perf_counter() - t0
        up.restore()
        t0 = time.perf_counter()
        cold = bytes(ssz.hash_tree_root(state))
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
    cold_launches = _build.launches["merkle_levels"]
    # the span builds: validators, inactivity scores, both participation lists
    n = len(pre.validators)
    k18_check("altair: the upgrade and its cold root", spans.calls, cold_launches,
              [n, -(-n // 4), -(-n // 32), -(-n // 32)])
    k18_err = spans.hold(mesh_merkle.merkle_levels_plain)
    print(f"altair: upgrade_to_altair of the {len(pre.validators)}-validator phase0 state "
          f"{t_up:.2f} s (the two sync committees {up.ms['get_next_sync_committee']:.2f} ms, "
          f"translate_participation {up.ms['translate_participation']:.2f} ms, host); cold root "
          f"{t_cold:.3f} s on K5 ({cold.hex()[:16]}); the upgrade's new lists and the root: "
          f"K18 {cold_launches} launches in {spans.count} span builds at leaves "
          f"{sorted(a[0].shape[0] for a, _ in spans.calls)}, each held against its plain "
          f"version (the root is checked through the block's state_root below) on {card}")

    dry = state.copy()
    t0 = time.perf_counter()
    spec.process_slots(dry, BLOCK_SLOT)
    t_slots_dry = time.perf_counter() - t0
    proposer = int(spec.get_beacon_proposer_index(dry))
    parts = signed_body(spec, dry, sks, pks, proposer)
    atts, bits = parts["atts"], parts["bits"]
    block = spec.BeaconBlock(
        slot=BLOCK_SLOT, proposer_index=proposer,
        parent_root=ssz.hash_tree_root(dry.latest_block_header),
        body=spec.BeaconBlockBody(randao_reveal=parts["randao"], eth1_data=dry.eth1_data,
                                  attestations=atts, sync_aggregate=parts["sync"]))
    print(f"altair block: slot {BLOCK_SLOT}, proposer {proposer}, {len(atts)} attestations, "
          f"a sync aggregate of {sum(bits)} of {SYNC} members, {len(atts) + 3} RLC items, "
          f"{parts['n_keys']} keys; set-up: committees {parts['comm_s']:.2f} s, signing "
          f"{parts['sign_s']:.2f} s (host)")
    signed = proposer_signer(spec, dry, sks, proposer)

    bls.bls_active = False
    t0 = time.perf_counter()
    spec.process_block(dry, block.copy())
    block.state_root = ssz.hash_tree_root(dry)
    t_dry = time.perf_counter() - t0
    bls.bls_active = True
    del dry
    print(f"altair dry run on a copy: process_slots {t_slots_dry:.2f} s, process_block + root "
          f"{t_dry:.2f} s")

    # -- the transition on the card, every K1-K5 call recorded ------------------
    tr = card_transition(torch, spec, state, signed(block.copy()),
                         ("process_slots", "process_block", "process_sync_aggregate",
                          "process_attestation"))
    batch, launches, ms, t_total = tr["batch"], tr["launches"], tr["ms"], tr["total_ms"]
    path_kernels = KERNELS + ("hash64",)
    check(batch.pairings == 1, f"altair: expected one product pairing, got {batch.pairings}")
    check(batch.last_results == [True] * (len(atts) + 3),
          f"altair: last_results must be {len(atts) + 3} x True")
    check(all(launches[k] > 0 for k in path_kernels),
          f"altair: a kernel of the transition was not launched: {launches}")
    rest = ms["process_block"] - ms["process_attestation"] - ms["process_sync_aggregate"] \
        - ms["flush"]
    print(f"altair state_transition: passed with {batch.pairings} product pairing, "
          f"{len(batch.last_results)} items; launches "
          f"{ {k: launches[k] for k in path_kernels} }")
    print(f"time altair state_transition (validate_result=True): {t_total:.2f} ms = slots "
          f"{ms['process_slots']:.2f} + process_attestation x{len(atts)} "
          f"{ms['process_attestation']:.2f} (flags, proposer reward, the signatures queued) + "
          f"process_sync_aggregate {ms['process_sync_aggregate']:.2f} + flush {ms['flush']:.2f} "
          f"(_decompress_g2 {ms['_decompress_g2']:.2f}) + rest of process_block {rest:.2f} + "
          f"state-root check and block signature "
          f"{t_total - ms['process_slots'] - ms['process_block']:.2f} on {card}")
    hashlib_roots.submit("the Altair block's post-state (the block's state_root)", spec, ssz,
                         tr["post"], bytes(block.state_root))
    del tr["post"]
    err = hold_new_shapes(torch, tr["recorders"], held, "altair")

    # -- the forged signature (phase 6 holds the wrong-root rejection) ------------
    forged = block.copy()
    forged.body.sync_aggregate.sync_committee_signature = atts[0].signature
    # items: the proposer signature, the randao reveal, the attestations,
    # the sync aggregate last
    two_rejections(spec, state, block, signed, forged, len(atts) + 2,
                   "a forged sync-aggregate signature", "altair", wrong_root=False)
    # phase 17 takes the pre-state on to Capella
    return {"launches": {k: launches[k] for k in path_kernels}, "err": err,
            "transition_ms": t_total, "upgrade_s": t_up, "k18_launches": cold_launches,
            "k18_err": k18_err, "state": state}


def altair_epoch_phase(torch, dev, card, pks, pre, quiet_pre, err: int) -> dict:
    """Phase 14: an Altair epoch transition of phase 10's not-leaking
    registry (``quiet_pre``: its 2^18 one, a depth cut, or None for
    ``pre`` itself), upgraded, through ``process_slots`` on the card,
    leaking and not leaking; phase 10's 2^20 registry ``pre`` upgraded and
    hashed for phase 20; the reduced leg at 4,096 validators.
    ``err``: phase 12's largest K13/K14 word difference."""
    import numpy as np
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    from consensus_specs_tpu_torch.utils import bls, ssz

    spec = build_spec("altair", "mainnet")
    sha256.install_merkle_hasher(dev)
    t0 = time.perf_counter()
    base = altair_epoch_state(spec, ssz, np, pre, seed=14)
    t_build = time.perf_counter() - t0
    n_pending = len(pre.previous_epoch_attestations)
    del pre                             # the caller holds no other reference
    t0 = time.perf_counter()
    cold = bytes(ssz.hash_tree_root(base))
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    state_arrays.reset_stats()
    t0 = time.perf_counter()
    store = state_arrays.of(base)
    store.registry()
    store.balances()
    store.column("inactivity_scores")
    store.participation("previous")
    t_extract = (time.perf_counter() - t0) * 1e3
    flags = store.participation("previous")
    print(f"altair epoch state: {len(base.validators)} validators at slot {EPOCH_SLOT}, previous "
          f"flags from {n_pending} pending attestations (source "
          f"{int((flags & 1).astype(bool).sum())}, target {int((flags & 2).astype(bool).sum())}, "
          f"head {int((flags & 4).astype(bool).sum())} lanes); set-up: upgrade and scatter "
          f"{t_build:.2f} s, cold root {t_cold:.3f} s on K5 ({cold.hex()[:16]}), column "
          f"extraction {t_extract:.2f} ms on {card}")
    p0 = build_spec("phase0", "mainnet")
    quiet = base
    if quiet_pre is not None:
        # phase 10's depth cut carried on: the not-leaking run on its 2^18
        # registry, upgraded the same way
        t0 = time.perf_counter()
        quiet = altair_epoch_state(spec, ssz, np, quiet_pre, seed=14)
        del quiet_pre
        ssz.hash_tree_root(quiet)
        print(f"altair epoch: both runs at {len(quiet.validators)} validators (phase 10's "
              f"depth cut); its state upgraded and hashed in "
              f"{time.perf_counter() - t0:.2f} s")
    bls.bls_active = False              # epoch processing verifies no signature
    # both runs take the not-leaking registry (a depth cut): the 2^20 base
    # goes on to phase 20, which runs K14, K13 and K12 at 2^20 lanes
    runs = {"not_leaking": epoch_run(torch, dev, card, spec, quiet, "altair not leaking")}
    runs["leaking"] = epoch_run(torch, dev, card, spec, leaking(spec, quiet), "altair leaking")
    check(not runs["not_leaking"]["in_leak"] and runs["leaking"]["in_leak"],
          "the two altair runs must be one not leaking and one leaking")
    bls.bls_active = True
    n = REDUCED_VALIDATORS
    small = altair_epoch_state(spec, ssz, np, epoch_state(p0, ssz, np, pks, n, seed=n), seed=n)
    bls.bls_active = False
    reduced_epoch_leg(torch, dev, spec, small, n)
    bls.bls_active = True
    # phase 18 upgrades the not-leaking registry (a depth cut) and the reduced
    # leg's state to Capella, phase 20 the untouched base and the reduced
    # leg's state to Deneb
    return {"runs": runs, "err": err, "extract_ms": t_extract, "cold_s": t_cold,
            "build_s": t_build, "base": base, "quiet": quiet, "small": small}


# ---------------------------------------------------------------------------
# slice 14: the Bellatrix and Capella runtimes (a mainnet Capella block with
# withdrawals and BLS-to-execution changes, a Capella epoch transition)
# ---------------------------------------------------------------------------

CHANGES = 16                # MAX_BLS_TO_EXECUTION_CHANGES
WITHDRAWALS = 16            # MAX_WITHDRAWALS_PER_PAYLOAD


def seeded_bytes(tag: bytes, n: int) -> bytes:
    return hashlib.sha256(SEED + tag).digest()[:n]


def after_merge(spec, state):
    """``state`` (Bellatrix) with a non-empty execution payload header, as
    a chain that went through the merge carries: the Capella paths run
    after it."""
    state.latest_execution_payload_header = spec.ExecutionPayloadHeader(
        parent_hash=seeded_bytes(b"el parent", 32), fee_recipient=seeded_bytes(b"el fee", 20),
        state_root=seeded_bytes(b"el state", 32), receipts_root=seeded_bytes(b"el receipts", 32),
        prev_randao=seeded_bytes(b"el randao", 32), block_number=17_034_869,
        gas_limit=30_000_000, gas_used=14_100_021, timestamp=int(state.genesis_time),
        base_fee_per_gas=27_000_000_000, block_hash=seeded_bytes(b"el block", 32),
        transactions_root=seeded_bytes(b"el txs", 32))
    return state


def to_capella(state):
    """An Altair ``state`` through ``upgrade_to_bellatrix`` (then the
    merge, :func:`after_merge`) and ``upgrade_to_capella``; returns (the
    Capella spec, the state, seconds of each upgrade)."""
    from consensus_specs_tpu_torch.forks import build_spec
    bspec, spec = build_spec("bellatrix", "mainnet"), build_spec("capella", "mainnet")
    t0 = time.perf_counter()
    mid = after_merge(bspec, bspec.upgrade_to_bellatrix(state))
    t1 = time.perf_counter()
    out = spec.upgrade_to_capella(mid)
    return spec, out, (t1 - t0, time.perf_counter() - t1)


def capella_lanes(n: int, keys: int) -> tuple:
    """(the lanes seeded for partial withdrawals, within the sweep's first
    16,384 and past the first ``keys``: a sync-committee reward goes to
    the first lane of a member's key, and no other payment of the block
    reaches these lanes but the proposer's; the lanes that send a
    BLS-to-execution change)."""
    step = min(n, 16384) // (2 * WITHDRAWALS)
    withdrawn = [keys + 37 + k * step for k in range(WITHDRAWALS)]
    changed = [n - 1 - 97 * k for k in range(CHANGES)]
    check(withdrawn[-1] < min(n, 16384) and not set(withdrawn) & set(changed)
          and min(changed) > 0, f"capella lanes at {n} validators")
    return withdrawn, changed


def block_payload(spec, dry, withdrawals, transactions=(), **fields):
    """The execution payload of the Capella-family blocks of phases 17 and
    19 on ``dry`` (the pre-state at ``BLOCK_SLOT``): seeded block fields,
    three seeded transactions and ``transactions``, ``withdrawals``, and
    ``fields`` (a later fork's)."""
    head = dry.latest_execution_payload_header
    return spec.ExecutionPayload(
        parent_hash=head.block_hash, fee_recipient=seeded_bytes(b"fee", 20),
        state_root=seeded_bytes(b"el state 3", 32), receipts_root=seeded_bytes(b"receipts", 32),
        prev_randao=spec.get_randao_mix(dry, spec.get_current_epoch(dry)),
        block_number=head.block_number + 1, gas_limit=head.gas_limit, gas_used=63_000,
        timestamp=spec.compute_timestamp_at_slot(dry, dry.slot), extra_data=b"chip-smoke",
        base_fee_per_gas=head.base_fee_per_gas, block_hash=seeded_bytes(b"el block 3", 32),
        transactions=[b"\x02" + seeded_bytes(b"tx" + bytes([k]), 32) * 3 for k in range(3)]
        + list(transactions), withdrawals=withdrawals, **fields)


def signed_changes(spec, domain, sks, pks, lanes) -> list:
    """A ``SignedBLSToExecutionChange`` of each lane in ``lanes``, from
    its own registry key to a seeded address."""
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as O
    changes = []
    for k, v in enumerate(lanes):
        msg = spec.BLSToExecutionChange(validator_index=v, from_bls_pubkey=pks[v % len(pks)],
                                        to_execution_address=seeded_bytes(b"to" + bytes([k]), 20))
        changes.append(spec.SignedBLSToExecutionChange(message=msg, signature=O.Sign(
            sks[v % len(sks)], spec.compute_signing_root(msg, domain))))
    return changes


def capella_block_phase(torch, dev, card, sks, pks, pre, held: set) -> dict:
    """Phase 17: a mainnet Capella block through ``state_transition`` on
    ``dev``: phase 13's Altair pre-state (2^20 validators) through
    ``upgrade_to_bellatrix`` and ``upgrade_to_capella``, 16 partial
    withdrawals seeded in the sweep's first 16,384 lanes (``0x01``
    credentials, 32 ETH effective, balance above it), a block at slot 3
    with phase 13's attestations and sync aggregate signed under the
    Capella fork version, a payload whose withdrawals are the expected
    ones, 16 BLS-to-execution changes of validators whose ``0x00``
    credentials come from their own registry keys, the proposer signature
    and the randao reveal (147 RLC items).  ``held`` as in phase 13."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls_torch
    from consensus_specs_tpu_torch.parallel import mesh_merkle
    from consensus_specs_tpu_torch.utils import bls, ssz
    from consensus_specs_tpu_torch.utils.hash_function import hash as sha

    n = len(pre.validators)
    withdrawn, changed = capella_lanes(n, len(pks))
    _build.reset_launches()
    with CallRecorder(torch, mesh_merkle, "merkle_levels") as spans:
        spec, state, t_up = to_capella(pre)
        del pre
        # the partial withdrawals: 0x01 credentials and an excess balance
        max_eb = int(spec.MAX_EFFECTIVE_BALANCE)
        for k, v in enumerate(withdrawn):
            state.validators[v].withdrawal_credentials = (
                spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX + b"\x00" * 11
                + seeded_bytes(b"withdraw" + bytes([k]), 20))
            state.balances[v] = max_eb + 1_000_003 * (k + 1)
        t0 = time.perf_counter()
        cold = bytes(ssz.hash_tree_root(state))
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
    cold_launches = _build.launches["merkle_levels"]
    # the span build: the registry's tree, built again in the new state as
    # in phase 13's upgrade (the other lists keep their trees)
    k18_check("capella: the upgrades and the cold root", spans.calls, cold_launches, [n])
    k18_err = spans.hold(mesh_merkle.merkle_levels_plain)
    for v in changed:
        check(bytes(state.validators[v].withdrawal_credentials)
              == spec.BLS_WITHDRAWAL_PREFIX + sha(pks[v % len(pks)])[1:],
              f"capella: validator {v} lacks its own key's 0x00 credentials")
    print(f"capella: upgrade_to_bellatrix {t_up[0]:.2f} s and upgrade_to_capella {t_up[1]:.2f} s "
          f"of the {n}-validator Altair state (host); {WITHDRAWALS} partial withdrawals seeded "
          f"at lanes {withdrawn[0]}..{withdrawn[-1]}; cold root {t_cold:.3f} s on K5 "
          f"({cold.hex()[:16]}); K18 {cold_launches} launches in {spans.count} span builds at "
          f"leaves {sorted(a[0].shape[0] for a, _ in spans.calls)}, each held against its "
          f"plain version on {card}")

    dry = state.copy()
    t0 = time.perf_counter()
    spec.process_slots(dry, BLOCK_SLOT)
    t_slots_dry = time.perf_counter() - t0
    proposer = int(spec.get_beacon_proposer_index(dry))
    parts = signed_body(spec, dry, sks, pks, proposer)
    atts = parts["atts"]
    t0 = time.perf_counter()
    expected = spec.get_expected_withdrawals(dry)
    t_expected = time.perf_counter() - t0
    check([int(w.validator_index) for w in expected] == withdrawn
          and [int(w.amount) for w in expected] == [1_000_003 * (k + 1)
                                                     for k in range(WITHDRAWALS)],
          f"capella: expected withdrawals {[(int(w.validator_index), int(w.amount)) for w in expected]}")
    payload = block_payload(spec, dry, expected)
    change_domain = spec.compute_domain(spec.DOMAIN_BLS_TO_EXECUTION_CHANGE,
                                        genesis_validators_root=dry.genesis_validators_root)
    t0 = time.perf_counter()
    changes = signed_changes(spec, change_domain, sks, pks, changed)
    t_changes = time.perf_counter() - t0
    block = spec.BeaconBlock(
        slot=BLOCK_SLOT, proposer_index=proposer,
        parent_root=ssz.hash_tree_root(dry.latest_block_header),
        body=spec.BeaconBlockBody(randao_reveal=parts["randao"], eth1_data=dry.eth1_data,
                                  attestations=atts, sync_aggregate=parts["sync"],
                                  execution_payload=payload, bls_to_execution_changes=changes))
    items = len(atts) + 3 + CHANGES
    print(f"capella block: slot {BLOCK_SLOT}, proposer {proposer}, {len(atts)} attestations, a "
          f"sync aggregate of {sum(parts['bits'])} of {SYNC} members, {len(expected)} "
          f"withdrawals (get_expected_withdrawals {t_expected * 1e3:.2f} ms), {CHANGES} "
          f"BLS-to-execution changes, {items} RLC items, {parts['n_keys'] + CHANGES} keys; "
          f"set-up: committees {parts['comm_s']:.2f} s, signing {parts['sign_s']:.2f} s, the "
          f"changes {t_changes:.2f} s (host)")
    signed = proposer_signer(spec, dry, sks, proposer)
    bls.bls_active = False
    t0 = time.perf_counter()
    spec.process_block(dry, block.copy())
    block.state_root = ssz.hash_tree_root(dry)
    t_dry = time.perf_counter() - t0
    bls.bls_active = True
    del dry
    print(f"capella dry run on a copy: process_slots {t_slots_dry:.2f} s, process_block + root "
          f"{t_dry:.2f} s")

    # -- the transition on the card, every K1-K5 call recorded, the batch's
    # items kept ----------------------------------------------------------------
    queued, add = [], bls.DeferredBatch.add

    def keep(self, pubkeys, message, signature, memo_key=None):
        queued.append((pubkeys, message, signature))
        return add(self, pubkeys, message, signature, memo_key)
    bls.DeferredBatch.add = keep
    try:
        tr = card_transition(torch, spec, state, signed(block.copy()),
                             ("process_slots", "process_block", "process_withdrawals",
                              "process_execution_payload", "process_attestation",
                              "process_bls_to_execution_change", "process_sync_aggregate"))
    finally:
        bls.DeferredBatch.add = add
    batch, launches, ms, t_total = tr["batch"], tr["launches"], tr["ms"], tr["total_ms"]
    post = tr["post"]
    path_kernels = KERNELS + ("hash64",)
    check(batch.pairings == 1, f"capella: expected one product pairing, got {batch.pairings}")
    check(batch.last_results == [True] * items, f"capella: last_results must be {items} x True")
    check(all(launches[k] > 0 for k in path_kernels),
          f"capella: a kernel of the transition was not launched: {launches}")
    check(int(post.next_withdrawal_index) == WITHDRAWALS
          and int(post.next_withdrawal_validator_index) == withdrawn[-1] + 1,
          f"capella: withdrawal cursors {int(post.next_withdrawal_index)}, "
          f"{int(post.next_withdrawal_validator_index)}")
    check(all(int(post.balances[v]) == max_eb for v in withdrawn if v != proposer),
          "capella: a withdrawn balance is not 32 ETH")
    check(all(bytes(post.validators[v].withdrawal_credentials)
              == spec.ETH1_ADDRESS_WITHDRAWAL_PREFIX + b"\x00" * 11
              + bytes(c.message.to_execution_address) for v, c in zip(changed, changes)),
          "capella: a BLS-to-execution change was not applied")
    check(bytes(post.latest_execution_payload_header.withdrawals_root)
          == bytes(ssz.hash_tree_root(payload.withdrawals)), "capella: withdrawals root")
    rest = ms["process_block"] - sum(ms[k] for k in (
        "process_withdrawals", "process_execution_payload", "process_attestation",
        "process_bls_to_execution_change", "process_sync_aggregate", "flush"))
    print(f"capella state_transition: passed with {batch.pairings} product pairing, "
          f"{len(batch.last_results)} items; next_withdrawal_index {int(post.next_withdrawal_index)}, "
          f"next_withdrawal_validator_index {int(post.next_withdrawal_validator_index)}; launches "
          f"{ {k: launches[k] for k in path_kernels} }")
    print(f"time capella state_transition (validate_result=True): {t_total:.2f} ms = slots "
          f"{ms['process_slots']:.2f} + process_withdrawals {ms['process_withdrawals']:.2f} + "
          f"process_execution_payload {ms['process_execution_payload']:.2f} + "
          f"process_attestation x{len(atts)} {ms['process_attestation']:.2f} + "
          f"process_bls_to_execution_change x{CHANGES} "
          f"{ms['process_bls_to_execution_change']:.2f} + process_sync_aggregate "
          f"{ms['process_sync_aggregate']:.2f} + flush {ms['flush']:.2f} (_decompress_g2 "
          f"{ms['_decompress_g2']:.2f}) + rest of process_block {rest:.2f} + state-root check "
          f"and block signature {t_total - ms['process_slots'] - ms['process_block']:.2f} on "
          f"{card}")
    hashlib_roots.submit("the Capella block's post-state (the block's state_root)", spec, ssz,
                         post, bytes(block.state_root))
    del post, tr["post"]
    err = hold_new_shapes(torch, tr["recorders"], held, "capella")
    held_here = {(r.name, str(r.shapes(a))) for r in tr["recorders"] for a, _ in r.calls}
    # K1-K4 at the Capella flush's shapes, per call queued ahead
    flush_calls = {r.name: r.calls[0][0] for r in tr["recorders"][:len(KERNELS)] if r.calls}
    shapes = {name: {"shapes": [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)],
                     "ms": queued_ms(torch, lambda: getattr(bls_torch, name)(*a), 5)}
              for name, a in flush_calls.items()}
    print("time at the capella flush's shapes (ms per call queued ahead): "
          + "; ".join(f"{k} {v['shapes'][0]} {v['ms']:.3f}" for k, v in shapes.items())
          + f" on {card}")

    # -- the BLS changes' share of the flush: the block's items with and
    # without the changes, in turns -------------------------------------------------
    check(len(queued) == items, f"capella: {len(queued)} items queued, expected {items}")
    change_roots = {bytes(spec.compute_signing_root(c.message, change_domain)) for c in changes}
    without = [it for it in queued if bytes(it[1]) not in change_roots]
    check(len(without) == items - CHANGES, "capella: the changes' items")

    def flush_of(its):
        b = bls.DeferredBatch()
        for it in its:
            b.add(*it)
        check(b.flush() is True and b.pairings == 1, "capella: a timed flush failed")
    turns = [cuda_ms(torch, lambda: flush_of(its)) for its in (queued, without, without, queued)]
    share = (turns[0] + turns[3] - turns[1] - turns[2]) / 2
    print(f"time capella flush: {items} items {turns[0]:.2f}, {turns[3]:.2f} ms; without the "
          f"{CHANGES} changes {turns[1]:.2f}, {turns[2]:.2f} ms: the changes' share "
          f"{share:.2f} ms (host work included) on {card}")

    # -- the forged signature (phase 6 holds the wrong-root rejection) ------------
    forged = block.copy()
    forged.body.bls_to_execution_changes[5].signature = changes[6].signature
    # items: the proposer signature, the randao reveal, the attestations,
    # the changes, the sync aggregate last
    two_rejections(spec, state, block, signed, forged, 2 + len(atts) + 5,
                   "a forged BLS-to-execution change 5", "capella", wrong_root=False)
    return {"launches": {k: launches[k] for k in path_kernels}, "err": err,
            "transition_ms": t_total, "upgrade_s": t_up, "k18_launches": cold_launches,
            "k18_err": k18_err, "withdrawals_ms": ms["process_withdrawals"],
            "flush_ms": ms["flush"], "changes_share_ms": share, "shapes": shapes,
            "k4_call": flush_calls.get("pairing_check"), "held": held_here, "state": state,
            "changed": changed}


def bellatrix_scalars(spec, run, slashed_sum: int, tag: str) -> dict:
    """C.1 and C.2 from the launch arguments K13 and K12 received in
    ``run``: K13's inactivity scalar must be ``INACTIVITY_SCORE_BIAS *
    INACTIVITY_PENALTY_QUOTIENT_BELLATRIX`` and K12's adjusted total
    Bellatrix's multiplier 3 of ``slashed_sum``, at which multipliers 3
    and 2 give different penalties."""
    s = run["calls"]["altair_deltas"][0][0][6]
    quotient = int(spec.config.INACTIVITY_SCORE_BIAS) * int(spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX)
    check(s.inactivity_denominator == quotient,
          f"{tag}: K13's inactivity scalar {s.inactivity_denominator}, expected {quotient}")
    args = run["calls"]["slashings"][0][0]
    inc, adjusted, total = (int(x) for x in args[3:6])
    check(adjusted == min(slashed_sum * 3, total),
          f"{tag}: K12's adjusted total {adjusted}: not multiplier 3 of {slashed_sum} "
          f"(total {total})")
    max_eb = int(spec.MAX_EFFECTIVE_BALANCE)
    penalty = lambda m: max_eb // inc * min(slashed_sum * m, total) // total * inc  # noqa: E731
    targets = int(args[2].sum())
    check(penalty(3) != penalty(2) and targets > 0,
          f"{tag}: multipliers 3 and 2 must differ on the run's targets: {penalty(3)}, "
          f"{penalty(2)}")
    print(f"{tag}: K13 took the inactivity scalar {s.inactivity_denominator} = "
          f"INACTIVITY_SCORE_BIAS x INACTIVITY_PENALTY_QUOTIENT_BELLATRIX (Altair's would be "
          f"{3 * quotient}); K12 the adjusted total {adjusted} = min(3 x {slashed_sum}, {total}): "
          f"{targets} target lanes lose {penalty(3)} gwei at 32 ETH ({penalty(2)} at Altair's "
          f"multiplier 2)")
    return {"inactivity_scalar": s.inactivity_denominator, "adjusted_total": adjusted}


def time_k13_k12(torch, card, ek, run, tag: str,
                 names=("altair_deltas", "slashings")) -> dict:
    """K13 and K12 (and the other epoch kernels of ``names``) per launch
    queued ahead at ``run``'s calls, beside their bounds and plain
    versions."""
    plain = epoch_plain(ek)
    times = {}
    for name in names:
        a = run["calls"][name][0][0]
        fn = getattr(ek, name)
        times[name] = queued_ms(torch, lambda: fn(*a))
        nbytes, ops = epoch_bound_counts(ek, name, a, True)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        print(f"time {name} at the {tag} epoch's call ({a[0].numel()} lanes): "
              f"{times[name]:.4f} ms per launch queued ahead (bound {bound:.5f} ms; plain on the "
              f"card {plain_ms(torch, lambda: plain[name](*a)):.3f} ms) on {card}")
    return times


def capella_epoch_phase(torch, dev, card, pks, quiet, small, err: int) -> dict:
    """Phase 18: a Capella epoch transition of phase 14's not-leaking
    Altair registry (``quiet``: 2^18 validators, a depth cut; its slashed
    validators' penalties due and ``slashings`` large enough that
    multiplier 3 and 2 give different penalties) through
    ``upgrade_to_bellatrix`` and ``upgrade_to_capella``, run once through
    ``process_slots`` leaking; from K13's and K12's recorded launch
    arguments, the Bellatrix inactivity quotient and slashing multiplier;
    K13 and K12 timed per launch; the reduced leg at 4,096 validators
    (``small``: phase 14's).  ``err``: phase 12's largest K13/K14 word
    difference."""
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.utils import bls, ssz
    from consensus_specs_tpu_torch.utils.ssz import merkle

    sha256.install_merkle_hasher(dev)
    spec, state, t_up = to_capella(quiet)
    del quiet
    merkle.reset_stats()
    t0 = time.perf_counter()
    cold = bytes(ssz.hash_tree_root(state))
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    st = merkle.stats()
    slashed_sum = sum(int(x) for x in state.slashings)
    print(f"capella epoch state: {len(state.validators)} validators at slot {EPOCH_SLOT} (phase "
          f"14's not-leaking registry, a depth cut); upgrade_to_bellatrix {t_up[0]:.2f} s, "
          f"upgrade_to_capella {t_up[1]:.2f} s (host); cold root {t_cold:.3f} s "
          f"({cold.hex()[:16]}; pairs by K5 {st['pairs_batched']}, by hashlib "
          f"{st['pairs_hashlib']}); slashings {slashed_sum} gwei on {card}")
    bls.bls_active = False              # epoch processing verifies no signature
    run = epoch_run(torch, dev, card, spec, leaking(spec, state, fork=False), "capella leaking",
                    fork=False)
    check(run["in_leak"], "the capella run must leak")
    del state
    scalars = bellatrix_scalars(spec, run, slashed_sum, "capella epoch")
    times = time_k13_k12(torch, card, ek, run, "capella")
    _, small, _ = to_capella(small)
    reduced_epoch_leg(torch, dev, spec, small, len(small.validators))
    bls.bls_active = True
    return {"runs": {"leaking": run}, "err": err, "cold_s": t_cold, "upgrade_s": t_up,
            "ms": times, "scalars": scalars}


# ---------------------------------------------------------------------------
# slice 15: the Deneb runtime (a mainnet block whose six-blob KZG batch joins
# the block's one product pairing, a Deneb epoch under the activation churn cap)
# ---------------------------------------------------------------------------

GAS_PER_BLOB = 2**17            # EIP-4844
PENDING = 32                    # validators queued for activation in phase 20
REDUCED_PENDING = 24            # and in its reduced leg
# the reduced leg's config: churn 16 at 4,096 validators, so the cap (8) binds
REDUCED_CHURN = {"MIN_PER_EPOCH_CHURN_LIMIT": 16}


class RecordingEngine:
    """An execution engine that accepts every payload and keeps what it
    was sent."""

    def __init__(self):
        self.requests = []

    def verify_and_notify_new_payload(self, request) -> bool:
        self.requests.append(request)
        return True


def deneb_lanes(n: int, keys: int) -> list:
    """The lanes that send a BLS-to-execution change in phase 19: none of
    phase 17's, and none it withdraws from (:func:`capella_lanes`)."""
    withdrawn, changed = capella_lanes(n, keys)
    lanes = [n - 50 - 97 * k for k in range(CHANGES)]
    check(not set(lanes) & (set(withdrawn) | set(changed)) and min(lanes) > 0,
          f"deneb lanes at {n} validators")
    return lanes


def deneb_block_phase(torch, dev, card, sks, pks, pre, blob: dict, held: set,
                      after_cold=None) -> dict:
    """Phase 19: a mainnet Deneb block through ``state_transition`` on
    ``dev``: phase 17's Capella pre-state (2^20 validators, its 16 partial
    withdrawals due) through ``upgrade_to_deneb``; a block at slot 3 with
    phase 17's content (128 attestations and the sync aggregate signed
    under the Deneb fork version, the 16 withdrawals, 16 BLS-to-execution
    changes on lanes phase 17 did not change), phase 8's six blob
    commitments and a payload with their blob gas and their blob
    transaction.  ``is_data_available`` (its ``retrieve_blobs_and_proofs``
    hands back phase 8's blobs and proofs) and ``state_transition`` share
    one batch scope, as ``on_block`` composes them: the KZG batch's two
    pairs join the block's 147 RLC items in one product pairing (one K4
    launch).  ``blob``: phase 8's result; ``held``: (kernel, argument
    shapes) held before; ``after_cold(state)``: called on the upgraded
    state after its cold root, before the state is transitioned in place
    (phase 21 takes its upgrade there), its result returned as
    ``forked``."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import bls_torch, msm
    from consensus_specs_tpu_torch.parallel import mesh_merkle
    from consensus_specs_tpu_torch.utils import bls, ssz
    from consensus_specs_tpu_torch.utils.hash_function import hash as sha

    spec = build_spec("deneb", "mainnet")
    n = len(pre.validators)
    withdrawn, _ = capella_lanes(n, len(pks))
    changed = deneb_lanes(n, len(pks))
    blobs, cs, proofs = blob["blobs"], blob["cs"], blob["proofs"]
    _build.reset_launches()
    with CallRecorder(torch, mesh_merkle, "merkle_levels") as spans:
        t0 = time.perf_counter()
        state = spec.upgrade_to_deneb(pre)
        t_up = time.perf_counter() - t0
        del pre
        t0 = time.perf_counter()
        cold = bytes(ssz.hash_tree_root(state))
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
    cold_launches = _build.launches["merkle_levels"]
    # the span build: the registry's tree, built again in the new state
    k18_check("deneb: the upgrade and the cold root", spans.calls, cold_launches, [n])
    k18_err = spans.hold(mesh_merkle.merkle_levels_plain)
    for v in changed:
        check(bytes(state.validators[v].withdrawal_credentials)
              == spec.BLS_WITHDRAWAL_PREFIX + sha(pks[v % len(pks)])[1:],
              f"deneb: validator {v} lacks its own key's 0x00 credentials")
    print(f"deneb: upgrade_to_deneb {t_up:.2f} s of phase 17's {n}-validator Capella "
          f"pre-state (host); cold root {t_cold:.3f} s on K5 ({cold.hex()[:16]}); K18 "
          f"{cold_launches} launches in {spans.count} span builds at leaves "
          f"{sorted(a[0].shape[0] for a, _ in spans.calls)}, each held against its plain "
          f"version on {card}")
    forked = after_cold(state) if after_cold is not None else None

    dry = state.copy()
    spec.process_slots(dry, BLOCK_SLOT)
    proposer = int(spec.get_beacon_proposer_index(dry))
    parts = signed_body(spec, dry, sks, pks, proposer)
    atts = parts["atts"]
    expected = spec.get_expected_withdrawals(dry)
    check([int(w.validator_index) for w in expected] == withdrawn,
          f"deneb: expected withdrawals at {[int(w.validator_index) for w in expected]}")
    hashes = [bytes(spec.kzg_commitment_to_versioned_hash(c)) for c in cs]
    payload = block_payload(spec, dry, expected, transactions=[b"\x03" + b"".join(hashes)],
                            blob_gas_used=len(cs) * GAS_PER_BLOB, excess_blob_gas=0)
    change_domain = spec.compute_domain(spec.DOMAIN_BLS_TO_EXECUTION_CHANGE,
                                        genesis_validators_root=dry.genesis_validators_root)
    t0 = time.perf_counter()
    changes = signed_changes(spec, change_domain, sks, pks, changed)
    t_changes = time.perf_counter() - t0
    block = spec.BeaconBlock(
        slot=BLOCK_SLOT, proposer_index=proposer,
        parent_root=ssz.hash_tree_root(dry.latest_block_header),
        body=spec.BeaconBlockBody(randao_reveal=parts["randao"], eth1_data=dry.eth1_data,
                                  attestations=atts, sync_aggregate=parts["sync"],
                                  execution_payload=payload, bls_to_execution_changes=changes,
                                  blob_kzg_commitments=cs))
    items = len(atts) + 3 + CHANGES
    print(f"deneb block: slot {BLOCK_SLOT}, proposer {proposer}, {len(atts)} attestations, a "
          f"sync aggregate of {sum(parts['bits'])} of {SYNC} members, {len(expected)} "
          f"withdrawals, {CHANGES} BLS-to-execution changes, {len(cs)} blob commitments "
          f"(MAX_BLOBS_PER_BLOCK {int(spec.MAX_BLOBS_PER_BLOCK)}; phase 8's blobs), {items} RLC "
          f"items and one deferred KZG check; set-up: committees {parts['comm_s']:.2f} s, "
          f"signing {parts['sign_s']:.2f} s, the changes {t_changes:.2f} s (host)")
    signed = proposer_signer(spec, dry, sks, proposer)
    bls.bls_active = False
    t0 = time.perf_counter()
    spec.process_block(dry, block.copy())
    block.state_root = ssz.hash_tree_root(dry)
    bls.bls_active = True
    del dry
    print(f"deneb dry run on a copy: process_block + root {time.perf_counter() - t0:.2f} s")

    # -- is_data_available and the transition in one scope on the card ------------
    engine, noop = RecordingEngine(), spec.EXECUTION_ENGINE
    spec.EXECUTION_ENGINE = engine
    spec.retrieve_blobs_and_proofs = lambda root: (blobs, proofs)
    root = ssz.hash_tree_root(block)
    avail = {}

    def availability():
        clock = StageClock(sync=torch.cuda.synchronize)
        for name in ("expand_windows", "msm_core"):
            clock.wrap(msm, name)
        t0 = time.perf_counter()
        try:
            avail["ok"] = spec.is_data_available(root, block.body.blob_kzg_commitments)
        finally:
            clock.restore()
        avail["ms"] = (time.perf_counter() - t0) * 1e3
        avail["device_ms"] = sum(clock.ms.values())

    queued, add = [], bls.DeferredBatch.add

    def keep(self, pubkeys, message, signature, memo_key=None):
        queued.append((pubkeys, message, signature))
        return add(self, pubkeys, message, signature, memo_key)
    bls.DeferredBatch.add = keep
    try:
        with CallRecorder(torch, msm, "expand_windows") as k7, \
                CallRecorder(torch, msm, "msm_core") as k8:
            tr = card_transition(torch, spec, state, signed(block.copy()),
                                 ("process_slots", "process_block", "process_execution_payload",
                                  "process_attestation"), within=availability, copy=False)
    finally:
        bls.DeferredBatch.add = add
    batch, launches, ms, t_total = tr["batch"], tr["launches"], tr["ms"], tr["total_ms"]
    post = tr["post"]
    path_kernels = KERNELS + ("hash64", "expand_windows", "g1_msm")
    k4_args = tr["recorders"][KERNELS.index("pairing_check")].calls[0][0]
    check(avail["ok"] is True, "deneb: is_data_available must answer True inside the scope")
    check(batch.pairings == 1 and launches["pairing_check"] == 1,
          f"deneb: expected one product pairing and one K4 launch for the block and its blobs, "
          f"got {batch.pairings} pairings, {launches['pairing_check']} K4 launches")
    check(batch.last_results == [True] * items and batch.last_pairing_results == [True],
          f"deneb: last_results must be {items} x True and last_pairing_results [True]")
    check(k4_args[0].shape[0] == items + 1 + 2,
          f"deneb: K4's group holds {k4_args[0].shape[0]} pairs, expected {items + 3}")
    check(all(launches[k] > 0 for k in path_kernels),
          f"deneb: a kernel of the block's path was not launched: {launches}")
    check(len(engine.requests) == 1, f"deneb: {len(engine.requests)} payloads sent to the engine")
    request = engine.requests[0]
    want_hashes = [b"\x01" + hashlib.sha256(bytes(c)).digest()[1:] for c in cs]
    check([bytes(h) for h in request.versioned_hashes] == want_hashes,
          "deneb: the engine's versioned hashes differ from 0x01 || sha256(commitment)[1:]")
    check(bytes(request.parent_beacon_block_root) == bytes(block.parent_root),
          "deneb: the engine's parent beacon block root")
    check(int(post.latest_execution_payload_header.blob_gas_used) == len(cs) * GAS_PER_BLOB
          and int(post.next_withdrawal_index) == WITHDRAWALS
          and int(post.next_withdrawal_validator_index) == withdrawn[-1] + 1,
          "deneb: the post-state's payload header or withdrawal cursors")
    rest = ms["process_block"] - sum(ms[k] for k in (
        "process_execution_payload", "process_attestation", "flush"))
    print(f"deneb: is_data_available and state_transition in one scope passed with "
          f"{batch.pairings} product pairing: {len(batch.last_results)} items and "
          f"{len(batch.last_pairing_results)} deferred check (kzg_batch) in one K4 group of "
          f"{k4_args[0].shape[0]} pairs; the engine saw {len(request.versioned_hashes)} versioned "
          f"hashes equal to 0x01 || sha256(commitment)[1:] and the parent root; launches "
          f"{ {k: launches[k] for k in path_kernels} }")
    print(f"time deneb is_data_available (6 blobs, deferred): {avail['ms']:.2f} ms = device "
          f"(K7 and K8 wrappers, synchronized) {avail['device_ms']:.2f} + host "
          f"{avail['ms'] - avail['device_ms']:.2f} on {card}")
    print(f"time deneb state_transition (validate_result=True): {t_total - avail['ms']:.2f} ms = "
          f"slots {ms['process_slots']:.2f} + process_execution_payload "
          f"{ms['process_execution_payload']:.2f} + process_attestation x{len(atts)} "
          f"{ms['process_attestation']:.2f} + flush {ms['flush']:.2f} (_decompress_g2 "
          f"{ms['_decompress_g2']:.2f}; {items} items and the KZG check) + rest of "
          f"process_block {rest:.2f} + state-root check and block signature "
          f"{t_total - avail['ms'] - ms['process_slots'] - ms['process_block']:.2f} on {card}")
    hashlib_roots.submit("the Deneb block's post-state (the block's state_root)", spec, ssz,
                         post, bytes(block.state_root))
    del post, tr["post"], state
    # every launched shape, before the holds drop the calls at shapes held before
    shapes = {r.name: sorted(r.by_shape) for r in tr["recorders"][:len(KERNELS)] + [k7, k8]}
    err = hold_new_shapes(torch, tr["recorders"] + [k7, k8], held, "deneb")
    held_here = {(r.name, str(r.shapes(a))) for r in tr["recorders"] + [k7, k8]
                 for a, _ in r.calls}
    k4_ms = queued_ms(torch, lambda: bls_torch.pairing_check(*k4_args), 5)
    print(f"time pairing_check at the deneb flush's group ({k4_args[0].shape[0]} pairs): "
          f"{k4_ms:.3f} ms per call queued ahead on {card}")

    # -- one blob's proof replaced by another's: the flush of the block's items
    # and the deferred check fails, and the bisect names the check alone --------
    check(len(queued) == items, f"deneb: {len(queued)} items queued, expected {items}")
    bad = list(proofs)
    bad[2] = proofs[3]
    spec.retrieve_blobs_and_proofs = lambda root: (blobs, bad)
    bls.clear_verify_memo()
    with bls.scoped_batch(bls.DeferredBatch()) as b:
        check(spec.is_data_available(root, block.body.blob_kzg_commitments) is True,
              "deneb: a deferred check answers True in the scope")
        for it in queued:
            b.add(*it)
        ok = b.flush()
    check(ok is False and b.last_results == [True] * items and b.last_pairing_results == [False],
          f"deneb: a wrong blob proof not named alone: {ok}, "
          f"{[i for i, r in enumerate(b.last_results or []) if not r]}, "
          f"{b.last_pairing_results}")
    print(f"deneb: blob 2's proof replaced by blob 3's: the flush fails, last_results {items} x "
          f"True, last_pairing_results {b.last_pairing_results} (the KZG check named alone; "
          f"{b.pairings} pairing evaluations with the bisect)")
    del spec.retrieve_blobs_and_proofs
    spec.EXECUTION_ENGINE = noop
    return {"launches": {k: launches[k] for k in path_kernels}, "err": err,
            "shapes": shapes, "transition_ms": t_total - avail["ms"], "available_ms": avail["ms"],
            "available_device_ms": avail["device_ms"], "upgrade_s": t_up,
            "k18_launches": cold_launches, "k18_err": k18_err, "flush_ms": ms["flush"],
            "k4_call": k4_args, "k4_ms": k4_ms, "held": held_here, "forked": forked,
            "changes": changes, "changed": changed, "withdrawn": withdrawn}


def add_pending(spec, state, pks, count: int) -> list:
    """``count`` deposits of 32 ETH appended to the registry through the
    spec's ``add_validator_to_registry`` (keys cycled, ``0x00`` credentials
    from their own keys), each eligible for activation since epoch 0:
    validators waiting in the activation queue.  Returns their lanes."""
    from consensus_specs_tpu_torch.utils.hash_function import hash as sha
    n = len(state.validators)
    for i in range(n, n + count):
        pk = pks[i % len(pks)]
        spec.add_validator_to_registry(state, pk, spec.BLS_WITHDRAWAL_PREFIX + sha(pk)[1:],
                                       spec.MAX_EFFECTIVE_BALANCE)
        state.validators[i].activation_eligibility_epoch = 0
    return list(range(n, n + count))


def activated(spec, lanes, cap: int):
    """A check of a post-state: exactly the first ``cap`` of ``lanes``
    (all eligible since epoch 0: the queue's order is the index) got an
    activation epoch, the next epoch past the seed lookahead."""
    def look(post):
        epochs = [int(post.validators[i].activation_epoch) for i in lanes]
        want = int(spec.compute_activation_exit_epoch(EPOCH_SLOT // 32))
        check(epochs[:cap] == [want] * cap and all(e == int(spec.FAR_FUTURE_EPOCH)
                                                    for e in epochs[cap:]),
              f"deneb: activation epochs of the queued lanes {epochs}")
        return [i for i, e in zip(lanes, epochs) if e == want]
    return look


def deneb_epoch_phase(torch, dev, card, pks, base, small, err: int) -> dict:
    """Phase 20: a Deneb epoch transition of phase 14's Altair base (2^20
    validators, its slashed validators' penalties due) through
    ``upgrade_to_bellatrix``, ``upgrade_to_capella`` and
    ``upgrade_to_deneb``, with 32 deposits queued for activation (eligible
    since epoch 0, so the churn limit stays 2^20 // 65536 = 16), run once
    through ``process_slots`` leaking on the mesh engine: exactly the first
    8 queued lanes are activated (EIP-7514's cap; Capella's rule would
    take 16), K13 and K12 take Bellatrix's scalars, every call is held,
    and the post-state ends at the hashlib root of a fresh
    deserialization.  The reduced leg at 4,096 validators (``small``:
    phase 14's) runs under ``MIN_PER_EPOCH_CHURN_LIMIT = 16`` with 24
    queued, so the cap binds there too.  ``err``: phase 12's largest
    K13/K14 word difference."""
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.utils import bls, ssz
    from consensus_specs_tpu_torch.utils.ssz import merkle

    sha256.install_merkle_hasher(dev)
    spec = build_spec("deneb", "mainnet")
    _, mid, t_up = to_capella(base)
    del base
    t0 = time.perf_counter()
    state = spec.upgrade_to_deneb(mid)
    t_up = t_up + (time.perf_counter() - t0,)
    del mid
    lanes = add_pending(spec, state, pks, PENDING)
    merkle.reset_stats()
    t0 = time.perf_counter()
    cold = bytes(ssz.hash_tree_root(state))
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    st = merkle.stats()
    slashed_sum = sum(int(x) for x in state.slashings)
    pre = leaking(spec, state, fork=False)
    del state
    churn = int(spec.get_validator_churn_limit(pre))
    eligible = sum(bool(spec.is_eligible_for_activation(pre, pre.validators[i])) for i in lanes)
    cap = int(spec.get_validator_activation_churn_limit(pre))
    check(eligible == PENDING and cap == min(int(spec.MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT), churn)
          and (len(pre.validators) - PENDING < 2**20 or (churn, cap) == (16, 8)),
          f"deneb epoch: churn {churn}, {eligible} eligible, activation churn {cap}")
    print(f"deneb epoch state: {len(pre.validators)} validators at slot {EPOCH_SLOT} "
          f"({len(pre.validators) - PENDING} active, {PENDING} queued for activation); "
          f"upgrade_to_bellatrix {t_up[0]:.2f} s, upgrade_to_capella {t_up[1]:.2f} s, "
          f"upgrade_to_deneb {t_up[2]:.2f} s (host); cold root {t_cold:.3f} s "
          f"({cold.hex()[:16]}; pairs by K5 {st['pairs_batched']}, by hashlib "
          f"{st['pairs_hashlib']}); slashings {slashed_sum} gwei; churn limit {churn}: "
          f"Capella's rule would activate {min(churn, eligible)} of the {eligible} eligible, "
          f"Deneb's activation churn limit {cap} on {card}")
    bls.bls_active = False              # epoch processing verifies no signature
    run = epoch_run(torch, dev, card, spec, pre, "deneb leaking",
                    inspect=activated(spec, lanes, cap), fork=False)
    check(run["in_leak"], "the deneb run must leak")
    del pre
    print(f"deneb epoch: activated lanes {run['inspected']} of the {PENDING} queued "
          f"({lanes[0]}..{lanes[-1]}): the first {cap} by (eligibility epoch, index)")
    scalars = bellatrix_scalars(spec, run, slashed_sum, "deneb epoch")
    times = time_k13_k12(torch, card, ek, run, "deneb",
                         ("inactivity_updates", "altair_deltas", "slashings"))
    ospec = build_spec("deneb", "mainnet", REDUCED_CHURN)
    _, small, _ = to_capella(small)
    small = ospec.upgrade_to_deneb(small)
    queued = add_pending(ospec, small, pks, REDUCED_PENDING)
    reduced_epoch_leg(torch, dev, ospec, small, len(small.validators),
                      post=lambda pre, s: activated(ospec, queued, 8)(s))
    bls.bls_active = True
    return {"runs": {"leaking": run}, "err": err, "cold_s": t_cold, "upgrade_s": t_up,
            "ms": times, "scalars": scalars, "activated": run["inspected"],
            "capella_rule": min(churn, eligible)}


# ---------------------------------------------------------------------------
# slice 16: the EIP-7594 runtime (a mainnet block whose six blobs are sampled
# by cell, each blob's cell batch joining the block's one product pairing)
# ---------------------------------------------------------------------------

WITHHELD = BLOBS - 1            # blobs the withholding stub hands back
ALTERED_BLOB = 2                # the blob with a changed sampled cell


def eip7594_upgrade(torch, card, pre) -> dict:
    """Phase 21's pre-state: ``upgrade_to_eip7594`` of phase 19's upgraded
    Deneb state ``pre`` (its cold root taken), a decode of its bytes and so
    the copy; the new state's cold root on K5 and K18 (every tree of 2^14
    chunks or more built anew: each span build checked and held against
    its plain version); every field's root but ``fork``'s equal to
    ``pre``'s."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.parallel import mesh_merkle
    from consensus_specs_tpu_torch.utils import ssz

    spec = build_spec("eip7594", "mainnet")
    n = len(pre.validators)
    _build.reset_launches()
    with CallRecorder(torch, mesh_merkle, "merkle_levels") as spans:
        t0 = time.perf_counter()
        state = spec.upgrade_to_eip7594(pre)
        t_up = time.perf_counter() - t0
        t0 = time.perf_counter()
        cold = bytes(ssz.hash_tree_root(state))
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
    launches = _build.launches["merkle_levels"]
    # the decoded state's trees: the registry, balances, both participation
    # lists, inactivity scores and the randao mixes
    k18_check("eip7594: the upgrade and the cold root", spans.calls, launches,
              [n, -(-n // 4), -(-n // 32), -(-n // 32), -(-n // 4),
               int(spec.EPOCHS_PER_HISTORICAL_VECTOR)])
    k18_err = spans.hold(mesh_merkle.merkle_levels_plain)
    differ = [f for f in type(state)._fields
              if bytes(ssz.hash_tree_root(getattr(state, f)))
              != bytes(ssz.hash_tree_root(getattr(pre, f)))]
    check(differ == ["fork"], f"eip7594: the upgrade changed {differ}, not only the fork")
    check(bytes(state.fork.current_version) == bytes(spec.config.EIP7594_FORK_VERSION)
          and bytes(state.fork.previous_version) == bytes(pre.fork.current_version),
          "eip7594: the upgraded state's fork versions")
    print(f"eip7594: upgrade_to_eip7594 {t_up:.2f} s of phase 19's {n}-validator Deneb state "
          f"(host: serialize and decode, the copy); cold root {t_cold:.3f} s on K5 "
          f"({cold.hex()[:16]}); K18 {launches} launches in {spans.count} span builds at leaves "
          f"{sorted(a[0].shape[0] for a, _ in spans.calls)}, each held against its plain "
          f"version; every field's root but the fork's equal to the pre-state's on {card}")
    return {"spec": spec, "state": state, "upgrade_s": t_up, "cold_s": t_cold,
            "k18_launches": launches, "k18_err": k18_err}


def altered_cell(cell: bytes) -> bytes:
    """``cell`` with its second field element plus one (mod r)."""
    from consensus_specs_tpu_torch.ops.kzg import BLS_MODULUS
    x = int.from_bytes(cell[32:64], "big")
    return cell[:32] + ((x + 1) % BLS_MODULUS).to_bytes(32, "big") + cell[64:]


class timed_calls:
    """While active, every call of the method ``cls.name`` is timed: ``ms``
    holds one wall-clock entry a call, in order."""

    def __init__(self, cls, name):
        self.cls, self.name, self.ms = cls, name, []

    def __enter__(self):
        self.saved = self.cls.__dict__.get(self.name)
        fn = getattr(self.cls, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)
        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            delattr(self.cls, self.name)
        else:
            setattr(self.cls, self.name, self.saved)


def forkchoice_store(torch, card, spec, state, block) -> dict:
    """Phase 21's fork-choice store on its pre-state ``state`` (slot 0):
    the registry columns extracted once on ``state`` (its copies share
    them copy-on-write, so the engine's first balance pass extracts
    nothing); the anchor block, ``state``'s header as a block with its
    ``state_root`` the state's root, whose root must be ``block``'s
    parent root; ``get_forkchoice_store`` (two state copies, the engine
    attached with one node); ``on_tick`` to the start of ``block``'s slot."""
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    from consensus_specs_tpu_torch.utils import ssz
    state_arrays.reset_stats()
    t0 = time.perf_counter()
    state_arrays.of(state).registry()
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state_root = ssz.hash_tree_root(state)
    root_s = time.perf_counter() - t0
    hdr = state.latest_block_header
    anchor = spec.BeaconBlock(slot=hdr.slot, proposer_index=hdr.proposer_index,
                              parent_root=hdr.parent_root, state_root=state_root,
                              body=spec.BeaconBlockBody())
    anchor_root = bytes(ssz.hash_tree_root(anchor))
    check(anchor_root == bytes(block.parent_root),
          "eip7594: the anchor block's root is not the block's parent root")
    with timed_calls(type(state), "copy") as copies:
        t0 = time.perf_counter()
        store = spec.get_forkchoice_store(state, anchor)
        store_s = time.perf_counter() - t0
    tick = int(store.genesis_time) + int(block.slot) * int(spec.config.SECONDS_PER_SLOT)
    spec.on_tick(store, tick)
    sa = state_arrays.stats()
    check(len(copies.ms) == 2 and store._fc_proto is not None and store._fc_proto._n == 1
          and int(spec.get_current_slot(store)) == int(block.slot)
          and sa.get("extracts", 0) <= 1,
          f"eip7594: the store: {len(copies.ms)} copies, slot {spec.get_current_slot(store)}, "
          f"column store {sa}")
    print(f"eip7594 fork-choice store on the {len(state.validators)}-validator pre-state: "
          f"registry columns extracted ({sa.get('extracts', 0)} extraction) {extract_s:.3f} s, "
          f"the state's root {root_s:.3f} s, "
          f"get_forkchoice_store {store_s:.3f} s (two state copies "
          f"{', '.join(f'{m / 1e3:.3f}' for m in copies.ms)} s, their column stores forked "
          f"{sa.get('forks', 0)} times); anchor {anchor_root.hex()[:16]} = the block's parent; "
          f"on_tick to slot {int(block.slot)} (host) on {card}")
    return {"store": store, "anchor_root": anchor_root, "extract_s": extract_s,
            "root_s": root_s, "store_s": store_s, "copy_ms": copies.ms}


def forkchoice_votes(torch, card, spec, store, sblock, anchor_state, parts, sks, held: set,
                     root: bytes, anchor_root: bytes) -> dict:
    """Phase 21 after ``on_block``: the block's attestations through
    ``on_attestation(is_from_block=True)`` twice.  First as a client
    following the head does it, the verify memo kept: ``on_block``'s flush
    answered every signature, so no kernel launches.  Then with the memo
    cleared, each verified alone outside any scope as an attestation
    arriving over gossip is (one K1, K3 and K4 launch each; the latest
    messages stay as the first pass wrote them).  ``get_head`` (first:
    the engine's balance pass over the registry, no column extracted;
    then warm) must be the block's root, answered by the engine;
    ``get_weight`` of the anchor and the block against the smoke's own
    sums: the voters' effective balances where active and not slashed,
    read from the anchor state's SSZ validators (and again from its
    columns), and the proposer score from the active total where the
    boost descends from the node; a double vote of 8 members of one committee, signed by
    their keys, through ``on_attester_slashing`` (two verifies): the
    anchor's weight falls by their balances, the head stays; ``on_tick``
    to the next slot: the boost is gone, both weights fall by the score.
    Every K1, K3 and K4 call at a shape no earlier phase held is held
    against its plain version (the first call of each shape)."""
    import numpy as np
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.forkchoice import proto_array
    from consensus_specs_tpu_torch.ops import bls_torch
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as O
    from consensus_specs_tpu_torch.ops.bls12_381.fields import R_ORDER
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    from consensus_specs_tpu_torch.utils import bls

    atts = list(sblock.message.body.attestations)
    names = ("g1_aggregate_scale", "hash_to_g2", "pairing_check")
    recs = [CallRecorder(torch, bls_torch, k, first_of_shape=True) for k in names]
    for r in recs:
        r.__enter__()
    try:
        # -- on_attestation with the memo kept: the block's flush answers -----------
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in atts:
            spec.on_attestation(store, a, is_from_block=True)
        torch.cuda.synchronize()
        kept_ms = (time.perf_counter() - t0) * 1e3
        kept_launches = {k: _build.launches[k] for k in names}
        check(all(v == 0 for v in kept_launches.values()),
              f"eip7594: {len(atts)} on_attestations after on_block's flush launched "
              f"{kept_launches}, expected the verify memo to answer each")
        voters = np.unique(np.concatenate([np.asarray(m, dtype=np.int64)
                                           for m in parts["committees"].values()]))
        msgs = store.latest_messages
        check(len(msgs) == voters.size == sum(len(m) for m in parts["committees"].values())
              and set(msgs) == set(voters.tolist())
              and all(bytes(m.root) == anchor_root for m in msgs.values()),
              f"eip7594: {len(msgs)} latest messages for {voters.size} voters, or one not on "
              f"the anchor")
        votes_before = dict(msgs)
        print(f"eip7594 on_attestation x{len(atts)} (is_from_block, the verify memo kept from "
              f"on_block's flush): {voters.size} votes, every one on the anchor; launches "
              f"{kept_launches}")
        print(f"time eip7594 on_attestation, following the head (memo kept, no launch): "
              f"{kept_ms:.2f} ms for {len(atts)}, {kept_ms / len(atts):.2f} a call (host) on "
              f"{card}")

        # -- on_attestation with the memo cleared: each verified alone ----------------
        clock = StageClock(sync=torch.cuda.synchronize)
        for k in names + ("_decompress_g2",):
            clock.wrap(bls_torch, k)
        bls.clear_verify_memo()
        _build.reset_launches()
        torch.cuda.synchronize()
        try:
            t0 = time.perf_counter()
            for a in atts:
                spec.on_attestation(store, a, is_from_block=True)
            torch.cuda.synchronize()
            att_ms = (time.perf_counter() - t0) * 1e3
        finally:
            clock.restore()
        att_launches = {k: _build.launches[k] for k in names}
        device_ms = sum(clock.ms[k] for k in names)
        check(all(att_launches[k] == len(atts) for k in names),
              f"eip7594: {len(atts)} on_attestations made {att_launches}, expected one launch "
              f"of each a call")
        check(store.latest_messages == votes_before,
              "eip7594: the second pass of on_attestation changed a latest message")
        print(f"eip7594 on_attestation x{len(atts)} (is_from_block, memo cleared: each verified "
              f"alone, as a gossip attestation is): launches {att_launches}")
        print(f"time eip7594 on_attestation, memo cleared (a gossip attestation verified alone): "
              f"{att_ms:.2f} ms for {len(atts)}, {att_ms / len(atts):.2f} a call = device (K1, K3, K4 wrappers, synchronized) "
              f"{device_ms:.2f} + _decompress_g2 {clock.ms['_decompress_g2']:.2f} + the rest "
              f"of the host {att_ms - device_ms - clock.ms['_decompress_g2']:.2f} on {card}")

        # -- the head and the weights ---------------------------------------------------
        proto_array.reset_stats()
        state_arrays.reset_stats()
        t0 = time.perf_counter()
        head = bytes(spec.get_head(store))
        head_first_ms = (time.perf_counter() - t0) * 1e3
        st, sa = proto_array.stats(), state_arrays.stats()
        check(head == root and st["proto_heads"] == 1 and st["spec_heads"] == 0
              and st["balance_passes"] == 1 and st["vote_deltas"] == voters.size
              and st["fallbacks"] == 0 and sa.get("extracts", 0) == 0,
              f"eip7594: get_head {head.hex()[:16]} (the block {root.hex()[:16]}), engine "
              f"{st}, column store {sa}")
        t0 = time.perf_counter()
        head = bytes(spec.get_head(store))
        head_warm_ms = (time.perf_counter() - t0) * 1e3
        check(head == root and proto_array.stats()["proto_heads"] == 2
              and proto_array.stats()["balance_passes"] == 1,
              "eip7594: the warm get_head")
        reg = state_arrays.of(anchor_state).registry()
        epoch = np.uint64(int(spec.get_current_epoch(anchor_state)))
        active = (reg["act"] <= epoch) & (epoch < reg["ext"])
        eff = reg["eff"].astype(np.int64)
        total = max(int(spec.EFFECTIVE_BALANCE_INCREMENT), int(eff[active].sum()))
        score = total // int(spec.SLOTS_PER_EPOCH) * int(spec.config.PROPOSER_SCORE_BOOST) // 100
        weigh = np.where(active & ~reg["sl"], eff, 0)
        # the voters' weights from the SSZ validators, apart from the columns
        t0 = time.perf_counter()
        ssz_weigh = {}
        for v in voters.tolist():
            val = anchor_state.validators[v]
            ok = (int(val.activation_epoch) <= int(epoch) < int(val.exit_epoch)
                  and not bool(val.slashed))
            ssz_weigh[v] = int(val.effective_balance) if ok else 0
        ssz_s = time.perf_counter() - t0
        vote_sum = sum(ssz_weigh.values())
        check(vote_sum == int(weigh[voters].sum()),
              f"eip7594: the voters' weight {vote_sum} from the SSZ validators, "
              f"{int(weigh[voters].sum())} from the columns")

        def weights():
            return int(spec.get_weight(store, anchor_root)), int(spec.get_weight(store, root))

        check(int(spec.get_proposer_score(store)) == score,
              f"eip7594: get_proposer_score {int(spec.get_proposer_score(store))}, numpy {score}")
        w_boost = weights()
        check(w_boost == (vote_sum + score, score),
              f"eip7594: weights {w_boost}, numpy {(vote_sum + score, score)}")
        print(f"eip7594 get_head = the block, answered by the proto-array engine (its balance "
              f"pass over {reg.size} lanes, no column extracted): first {head_first_ms:.2f} ms, "
              f"warm {head_warm_ms:.2f} ms (host) on {card}; get_weight anchor {w_boost[0]} = "
              f"{voters.size} votes {vote_sum} + proposer score {score}, block {w_boost[1]} = "
              f"the score, each equal to the smoke's sums (the votes read from the SSZ "
              f"validators in {ssz_s:.3f} s and equal to the column sum)")

        # -- a double vote through on_attester_slashing -----------------------------------
        (slot, index), members = next(iter(parts["committees"].items()))
        eight = sorted(int(v) for v in members)[:8]
        data1 = next(a.data for a in atts
                     if int(a.data.slot) == slot and int(a.data.index) == index)
        data2 = data1.copy()
        data2.beacon_block_root = root
        domain = spec.get_domain(anchor_state, spec.DOMAIN_BEACON_ATTESTER,
                                 data1.target.epoch)
        sk = sum(sks[v % len(sks)] for v in eight) % R_ORDER
        pair = [spec.IndexedAttestation(
            attesting_indices=eight, data=d,
            signature=O.Sign(sk, spec.compute_signing_root(d, domain))) for d in (data1, data2)]
        slashing = spec.AttesterSlashing(attestation_1=pair[0], attestation_2=pair[1])
        bls.clear_verify_memo()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec.on_attester_slashing(store, slashing)
        torch.cuda.synchronize()
        slash_ms = (time.perf_counter() - t0) * 1e3
        slash_launches = {k: _build.launches[k] for k in names}
        lost = sum(ssz_weigh[v] for v in eight)
        check(lost == int(weigh[eight].sum()),
              f"eip7594: the slashed voters' weight {lost} from the SSZ validators, "
              f"{int(weigh[eight].sum())} from the columns")
        w_slashed = weights()
        check(slash_launches == dict.fromkeys(names, 2) and store.equivocating_indices == set(eight)
              and w_slashed == (vote_sum - lost + score, score)
              and bytes(spec.get_head(store)) == root,
              f"eip7594: the slashing: launches {slash_launches}, equivocating "
              f"{sorted(store.equivocating_indices)}, weights {w_slashed}, numpy "
              f"{(vote_sum - lost + score, score)}")
        spec.on_tick(store, int(store.genesis_time)
                     + (int(sblock.message.slot) + 1) * int(spec.config.SECONDS_PER_SLOT))
        w_tick = weights()
        st = proto_array.stats()
        check(bytes(store.proposer_boost_root) == b"\x00" * 32
              and w_tick == (vote_sum - lost, 0) and bytes(spec.get_head(store)) == root
              and st["spec_heads"] == st["spec_weights"] == st["fallbacks"] == 0,
              f"eip7594: after the tick: weights {w_tick}, numpy {(vote_sum - lost, 0)}, "
              f"engine {st}")
        print(f"eip7594 on_attester_slashing: a double vote of validators {eight} (slot {slot}, "
              f"committee {index}) equivocating; launches {slash_launches}; {slash_ms:.2f} ms on "
              f"{card}; anchor weight {w_boost[0]} -> {w_slashed[0]} (their balances {lost}), "
              f"head unchanged; on_tick to slot {int(sblock.message.slot) + 1}: the boost gone, "
              f"weights {w_tick}; every read the engine's ({st})")
    finally:
        for r in reversed(recs):
            r.__exit__()
    firsts = {r.name: {str(r.shapes(a)): a for a, _ in r.calls} for r in recs}
    err = hold_new_shapes(torch, recs, held, "eip7594 on_attestation and on_attester_slashing")
    shape_ms = {name: {sh: queued_ms(torch, lambda a=a, fn=getattr(bls_torch, name): fn(*a), 10)
                       for sh, a in calls.items()} for name, calls in firsts.items()}
    print("time g1_aggregate_scale, hash_to_g2 and pairing_check at the fork-choice verifies' "
          "shapes (ms per call queued ahead): " + "; ".join(
              f"{k} {sh} {v:.4f}" for k, d in shape_ms.items() for sh, v in d.items())
          + f" on {card}")
    return {"err": err, "shape_ms": shape_ms, "att_launches": att_launches,
            "kept_launches": kept_launches, "slash_launches": slash_launches,
            "kept_ms": kept_ms, "att_ms": att_ms, "att_device_ms": device_ms,
            "att_decompress_ms": clock.ms["_decompress_g2"], "votes": int(voters.size),
            "head_first_ms": head_first_ms, "head_warm_ms": head_warm_ms,
            "slash_ms": slash_ms, "weights": [w_boost, w_slashed, w_tick],
            "shapes": {r.name: sorted(r.by_shape) for r in recs}}


def eip7594_block_phase(torch, dev, card, sks, pks, up: dict, dblock: dict, blob: dict,
                        das: dict, held: set) -> dict:
    """Phase 21: a mainnet EIP-7594 block through fork choice's
    ``on_block`` on ``dev``: ``up``'s state (:func:`eip7594_upgrade` of
    phase 19's Deneb state; its header takes this fork's empty body root,
    so that it is an EIP-7594 anchor block), a block at slot 3 with phase
    19's content (128 attestations, the sync aggregate, the proposer
    signature and the randao reveal signed under the EIP-7594 fork
    version; the same 16 withdrawals; phase 19's 16 BLS-to-execution
    changes as they are, signed under the genesis domain; phase 8's six
    commitments with their blob transaction and blob gas: 147 RLC items).
    The store is built on the pre-state and ticked to slot 3
    (:func:`forkchoice_store`).  First, with a blob withheld, ``on_block``
    raises with no launch and the store as it was.  Then ``on_block``
    samples ``SAMPLES_PER_SLOT`` columns of each blob through
    ``is_data_available`` (its ``retrieve_cells_and_proofs`` hands back
    phase 9's 8 columns, cells and proofs) in its one batch scope with
    ``state_transition`` (joined to this phase's ``scoped_batch``): each
    blob's cell batch defers its two pairs, and the 147 items and the six
    checks pass as one product pairing, one K4 launch of one group of 160
    pairs; the block is stored, timely, with the proposer boost.  The
    block's attestations, the head, the weights, a slashing and a tick
    follow (:func:`forkchoice_votes`).  Then: a withheld blob answers
    False with no launch; outside a block, a scope holding only
    ``is_data_available`` with one element of one cell of blob 2 changed
    fails its flush, ``last_pairing_results`` naming that blob's check
    alone; the 8 columns as ``DataColumnSidecar``s around the block's
    signed header verify (one K4 launch of 2 pairs each, outside a scope);
    blob 0 through ``recover_polynomial`` from phase 9's kept half equals
    its extended cells (4 K9 launches, each held).  Every K1-K5, K7 and K8
    call at a shape no earlier phase held (``held``) is held against its
    plain version (K4's GT values too; K7 and K8 by shape,
    :func:`hold_msm_by_shape`)."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls_torch, fr_fft, msm
    from consensus_specs_tpu_torch.utils import bls, ssz

    spec, state = up["spec"], up.pop("state")
    cs, sampling = blob["cs"], das["sampling"]
    cols = sampling[0][0]
    check(len(sampling) == len(cs) and all(ids == cols for ids, _, _ in sampling)
          and len(cols) == int(spec.SAMPLES_PER_SLOT),
          f"eip7594: phase 9's sampling must give {int(spec.SAMPLES_PER_SLOT)} columns a blob")
    # the registry state's header carries the phase0 empty body's root; with
    # this fork's, the header is an EIP-7594 block: the store's anchor
    state.latest_block_header.body_root = ssz.hash_tree_root(spec.BeaconBlockBody())
    dry = state.copy()
    spec.process_slots(dry, BLOCK_SLOT)
    proposer = int(spec.get_beacon_proposer_index(dry))
    parts = signed_body(spec, dry, sks, pks, proposer)
    atts = parts["atts"]
    expected = spec.get_expected_withdrawals(dry)
    check([int(w.validator_index) for w in expected] == dblock["withdrawn"],
          f"eip7594: expected withdrawals at {[int(w.validator_index) for w in expected]}")
    hashes = [bytes(spec.kzg_commitment_to_versioned_hash(c)) for c in cs]
    payload = block_payload(spec, dry, expected, transactions=[b"\x03" + b"".join(hashes)],
                            blob_gas_used=len(cs) * GAS_PER_BLOB, excess_blob_gas=0)
    changes = [ssz.deserialize(spec.SignedBLSToExecutionChange, ssz.serialize(c))
               for c in dblock["changes"]]
    block = spec.BeaconBlock(
        slot=BLOCK_SLOT, proposer_index=proposer,
        parent_root=ssz.hash_tree_root(dry.latest_block_header),
        body=spec.BeaconBlockBody(randao_reveal=parts["randao"], eth1_data=dry.eth1_data,
                                  attestations=atts, sync_aggregate=parts["sync"],
                                  execution_payload=payload, bls_to_execution_changes=changes,
                                  blob_kzg_commitments=cs))
    items = len(atts) + 3 + len(changes)
    print(f"eip7594 block: slot {BLOCK_SLOT}, proposer {proposer}, {len(atts)} attestations, a "
          f"sync aggregate of {sum(parts['bits'])} of {SYNC} members, {len(expected)} "
          f"withdrawals, phase 19's {len(changes)} BLS-to-execution changes, {len(cs)} blob "
          f"commitments sampled at columns {cols} (SAMPLES_PER_SLOT "
          f"{int(spec.SAMPLES_PER_SLOT)} of NUMBER_OF_COLUMNS {int(spec.NUMBER_OF_COLUMNS)}), "
          f"{items} RLC items and {len(cs)} deferred cell checks; set-up: committees "
          f"{parts['comm_s']:.2f} s, signing {parts['sign_s']:.2f} s (host)")
    signed = proposer_signer(spec, dry, sks, proposer)
    bls.bls_active = False
    t0 = time.perf_counter()
    spec.process_block(dry, block.copy())
    block.state_root = ssz.hash_tree_root(dry)
    bls.bls_active = True
    del dry
    print(f"eip7594 dry run on a copy: process_block + root {time.perf_counter() - t0:.2f} s")
    sblock = signed(block.copy())

    # -- the fork-choice store on the pre-state ------------------------------------
    engine, noop = RecordingEngine(), spec.EXECUTION_ENGINE
    spec.EXECUTION_ENGINE = engine
    root = bytes(ssz.hash_tree_root(block))
    fc = forkchoice_store(torch, card, spec, state, block)
    store, anchor_root = fc["store"], fc["anchor_root"]
    del state
    anchor_state = store.block_states[anchor_root]
    nodes = lambda: (len(store.blocks), len(store.block_states), store._fc_proto._n)  # noqa: E731

    # -- a withheld blob: on_block refuses the block before any pairing --------------
    spec.retrieve_cells_and_proofs = lambda r: sampling[:WITHHELD]
    before = nodes()
    bls.clear_verify_memo()
    _build.reset_launches()
    t0 = time.perf_counter()
    with bls.scoped_batch(bls.DeferredBatch()) as wb:
        try:
            spec.on_block(store, sblock)
            fail(f"eip7594: on_block passed with {WITHHELD} of {len(cs)} blobs sampled")
        except AssertionError:
            pass
    torch.cuda.synchronize()
    withheld_ms = (time.perf_counter() - t0) * 1e3
    refused = {k: _build.launches[k] for k in ("pairing_check", "expand_windows", "g1_msm")}
    check(nodes() == before == (1, 1, 1) and not any(refused.values()) and wb.pairings == 0
          and wb.items == [] and wb.pairing_checks == [] and root not in store.blocks,
          f"eip7594: the withheld block changed the store or launched: {nodes()}, {refused}, "
          f"{wb.pairings} pairings")
    print(f"eip7594 on_block with {WITHHELD} of {len(cs)} blobs sampled: AssertionError with no "
          f"launch ({refused}) and no pairing; store.blocks, block_states and the engine's nodes "
          f"{nodes()} as they were; {withheld_ms:.2f} ms (the pre-state copy, host) on {card}")

    # -- on_block: is_data_available and the transition in one scope on the card ---
    spec.retrieve_cells_and_proofs = lambda r: sampling
    dev_clock = StageClock(sync=torch.cuda.synchronize)
    for name in ("expand_windows", "msm_core"):
        dev_clock.wrap(msm, name)
    try:
        with CallRecorder(torch, msm, "expand_windows") as k7, \
                CallRecorder(torch, msm, "msm_core") as k8, \
                timed_calls(type(anchor_state), "copy") as copies:
            tr = card_transition(torch, spec, None, sblock,
                                 ("is_data_available", "state_transition", "process_slots",
                                  "process_block", "process_execution_payload",
                                  "process_attestation", "compute_pulled_up_tip"),
                                 run=lambda: spec.on_block(store, sblock))
    finally:
        dev_clock.restore()
    batch, launches, ms, t_total = tr["batch"], tr["launches"], tr["ms"], tr["total_ms"]
    post = store.block_states[root]
    path_kernels = KERNELS + ("hash64", "expand_windows", "g1_msm")
    k4_args = tr["recorders"][KERNELS.index("pairing_check")].calls[0][0]
    pairs = items + 1 + 2 * len(cs)
    check(batch.pairings == 1 and launches["pairing_check"] == 1,
          f"eip7594: expected one product pairing and one K4 launch for the block and its "
          f"blobs' cells, got {batch.pairings} pairings, {launches['pairing_check']} K4 launches")
    check(batch.last_results == [True] * items
          and batch.last_pairing_results == [True] * len(cs),
          f"eip7594: last_results must be {items} x True and last_pairing_results "
          f"{len(cs)} x True")
    check(k4_args[0].shape[0] == pairs and k4_args[3].shape[0] == 2,
          f"eip7594: K4's call holds {k4_args[0].shape[0]} pairs in "
          f"{k4_args[3].shape[0] - 1} groups, expected one group of {pairs}")
    check(all(launches[k] > 0 for k in path_kernels),
          f"eip7594: a kernel of the block's path was not launched: {launches}")
    check(len(engine.requests) == 1 and [bytes(h) for h in engine.requests[0].versioned_hashes]
          == [b"\x01" + hashlib.sha256(bytes(c)).digest()[1:] for c in cs],
          "eip7594: the engine's versioned hashes")
    check(bytes(post.fork.current_version) == bytes(spec.config.EIP7594_FORK_VERSION)
          and int(post.latest_execution_payload_header.blob_gas_used) == len(cs) * GAS_PER_BLOB
          and int(post.next_withdrawal_index) == WITHDRAWALS,
          "eip7594: the post-state's fork, payload header or withdrawal cursor")
    check(nodes() == (2, 2, 2) and bytes(store.proposer_boost_root) == root
          and store.block_timeliness[root] is True
          and bytes(store.blocks[root].parent_root) == anchor_root,
          f"eip7594: on_block's store: nodes {nodes()}, boost "
          f"{bytes(store.proposer_boost_root).hex()[:16]}, timely "
          f"{store.block_timeliness.get(root)}")
    check(len(copies.ms) == 2, f"eip7594: on_block copied {len(copies.ms)} states, expected 2 "
                               f"(the pre-state, compute_pulled_up_tip's)")
    rest = ms["process_block"] - sum(ms[k] for k in (
        "process_execution_payload", "process_attestation", "flush"))
    on_block_rest = t_total - (copies.ms[0] + ms["is_data_available"] + ms["state_transition"]
                               + ms["compute_pulled_up_tip"])
    print(f"eip7594: on_block passed the block (root {root.hex()[:16]}) with {batch.pairings} "
          f"product pairing: {len(batch.last_results)} items and "
          f"{len(batch.last_pairing_results)} deferred checks (das_cells, one a blob) in one K4 "
          f"group of {k4_args[0].shape[0]} pairs; the store holds it, timely, with the proposer "
          f"boost; the post-state carries fork version "
          f"{bytes(post.fork.current_version).hex()}; launches "
          f"{ {k: launches[k] for k in path_kernels} }")
    print(f"time eip7594 on_block: {t_total:.2f} ms = pre-state copy {copies.ms[0]:.2f} + "
          f"is_data_available {ms['is_data_available']:.2f} ({len(cs)} blobs x {len(cols)} "
          f"cells, deferred; device: K7 and K8 wrappers, synchronized, "
          f"{sum(dev_clock.ms.values()):.2f}) + state_transition {ms['state_transition']:.2f} + "
          f"compute_pulled_up_tip {ms['compute_pulled_up_tip']:.2f} (its copy "
          f"{copies.ms[1]:.2f}) + rest {on_block_rest:.2f} on {card}")
    print(f"time eip7594 state_transition (validate_result=True): {ms['state_transition']:.2f} "
          f"ms = slots {ms['process_slots']:.2f} + process_execution_payload "
          f"{ms['process_execution_payload']:.2f} + process_attestation x{len(atts)} "
          f"{ms['process_attestation']:.2f} + flush {ms['flush']:.2f} (_decompress_g2 "
          f"{ms['_decompress_g2']:.2f}; {items} items and {len(cs)} cell checks) + rest of "
          f"process_block {rest:.2f} + state-root check and block signature "
          f"{ms['state_transition'] - ms['process_slots'] - ms['process_block']:.2f} on {card}")
    hashlib_roots.submit("the EIP-7594 block's post-state (the block's state_root)", spec, ssz,
                         post, bytes(block.state_root))
    del post
    shapes = {r.name: sorted(r.by_shape) for r in tr["recorders"][:len(KERNELS)] + [k7, k8]}
    err = hold_new_shapes(torch, tr["recorders"], held, "eip7594")
    err.update(hold_msm_by_shape(torch, k7, k8, held, "eip7594"))
    held = held | {(r.name, str(r.shapes(a))) for r in tr["recorders"] + [k7, k8]
                   for a, _ in r.calls}
    k4_ms = queued_ms(torch, lambda: bls_torch.pairing_check(*k4_args), 5)
    print(f"time pairing_check at the eip7594 flush's group ({k4_args[0].shape[0]} pairs): "
          f"{k4_ms:.3f} ms per call queued ahead on {card}")
    # K7 and K8 at each shape the cell batches gave them, at its first call
    shape_ms = {}
    for r, name in ((k7, "expand_windows"), (k8, "g1_msm")):
        firsts = {}
        for a, _ in r.calls:
            firsts.setdefault(str(r.shapes(a)), a)
        fn = getattr(msm, r.name)
        shape_ms[name] = {sh: queued_ms(torch, lambda: fn(*a), 10) for sh, a in firsts.items()}
    print("time expand_windows and g1_msm at the eip7594 cell batches' shapes (ms per call "
          "queued ahead): " + "; ".join(f"{k} {sh} {ms:.4f}" for k, v in shape_ms.items()
                                        for sh, ms in v.items()) + f" on {card}")

    # -- the block's attestations, the head, the weights, a slashing, a tick ---------
    votes = forkchoice_votes(torch, card, spec, store, sblock, anchor_state, parts,
                             sks, held, root, anchor_root)
    err.update({k: max(err.get(k, 0), v) for k, v in votes["err"].items()})
    del anchor_state

    # -- a withheld blob; a changed cell outside a block; the sidecars ---------------
    recs = [CallRecorder(torch, bls_torch, "pairing_check"),
            CallRecorder(torch, msm, "expand_windows"), CallRecorder(torch, msm, "msm_core")]
    for r in recs:
        r.__enter__()
    try:
        spec.retrieve_cells_and_proofs = lambda root: sampling[:WITHHELD]
        _build.reset_launches()
        check(spec.is_data_available(root, cs) is False,
              f"eip7594: {WITHHELD} of {len(cs)} blobs sampled must answer False")
        torch.cuda.synchronize()
        withheld = {k: _build.launches[k] for k in ("pairing_check", "expand_windows", "g1_msm")}
        check(not any(withheld.values()), f"eip7594: the withheld blob launched {withheld}")

        bad = list(sampling)
        ids, cells, proofs = sampling[ALTERED_BLOB]
        bad[ALTERED_BLOB] = (ids, [altered_cell(cells[0])] + list(cells[1:]), proofs)
        spec.retrieve_cells_and_proofs = lambda root: bad
        bls.clear_verify_memo()
        _build.reset_launches()
        with bls.scoped_batch(bls.DeferredBatch()) as b:
            check(spec.is_data_available(root, cs) is True,
                  "eip7594: a deferred cell check answers True in the scope")
            ok = b.flush()
        torch.cuda.synchronize()
        altered_k4 = _build.launches["pairing_check"]
        named = [True] * len(cs)
        named[ALTERED_BLOB] = False
        check(ok is False and b.last_results == [] and b.last_pairing_results == named,
              f"eip7594: a changed cell of blob {ALTERED_BLOB} not named alone: {ok}, "
              f"{b.last_results}, {b.last_pairing_results}")
        check(altered_k4 == 1 + len(cs), f"eip7594: {altered_k4} K4 launches for the flush and "
                                         f"its {len(cs)} checks alone")
        print(f"eip7594: {WITHHELD} of {len(cs)} blobs sampled: False with no launch; outside a "
              f"block, one element of a cell of blob {ALTERED_BLOB} changed: the flush of the "
              f"{len(cs)} deferred checks fails, last_pairing_results {b.last_pairing_results} "
              f"({b.pairings} pairing evaluations, {altered_k4} K4 launches, no item and no G2 "
              f"decompression)")

        header = spec.signed_block_header(sblock)
        sidecars = [spec.DataColumnSidecar(
            index=c, column=[cl[k] for _, cl, _ in sampling], kzg_commitments=cs,
            kzg_proofs=[pr[k] for _, _, pr in sampling], signed_block_header=header)
            for k, c in enumerate(cols)]
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for sc in sidecars:
            check(spec.verify_data_column_sidecar(sc) is True,
                  f"eip7594: sidecar {int(sc.index)} is not well formed")
            check(spec.verify_data_column_sidecar_kzg_proofs(sc) is True,
                  f"eip7594: sidecar {int(sc.index)}'s cells must verify")
        torch.cuda.synchronize()
        sidecar_ms = (time.perf_counter() - t0) * 1e3
        sidecar_launches = {k: _build.launches[k] for k in ("pairing_check", "expand_windows",
                                                            "g1_msm")}
        check(sidecar_launches["pairing_check"] == len(sidecars),
              f"eip7594: the sidecars made {sidecar_launches['pairing_check']} K4 launches, "
              f"expected one each")
        print(f"eip7594: {len(sidecars)} DataColumnSidecars around the block's signed header "
              f"(columns {cols}, {len(cs)} cells each) pass verify_data_column_sidecar and "
              f"verify_data_column_sidecar_kzg_proofs outside a scope; launches "
              f"{sidecar_launches}; {sidecar_ms:.2f} ms in all ({sidecar_ms / len(sidecars):.2f} "
              f"a sidecar, host work included) on {card}")
    finally:
        for r in reversed(recs):
            r.__exit__()
        if "retrieve_cells_and_proofs" in vars(spec):
            del spec.retrieve_cells_and_proofs
        spec.EXECUTION_ENGINE = noop
    tag = "eip7594 withheld, changed cell and sidecars"
    err_more = hold_new_shapes(torch, recs[:1], held, tag)
    err_more.update(hold_msm_by_shape(torch, recs[1], recs[2], held, tag))

    # -- blob 0 recovered from phase 9's kept half through the spec -----------------
    ids, cells_b = das["recover_request"]
    with CallRecorder(torch, fr_fft, "fr_fft") as k9:
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = spec.recover_polynomial(ids, cells_b)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t0) * 1e3
        k9_launches = _build.launches["fr_fft"]
    check(data == das["extended"], "eip7594: recover_polynomial differs from blob 0's cells")
    check(k9_launches == k9.count == 4,
          f"eip7594: recover_polynomial made {k9_launches} K9 launches in {k9.count} calls, "
          f"expected 4 (one a batched FFT)")
    err9 = k9.hold(fr_fft.fr_fft_plain)
    print(f"eip7594: recover_polynomial of blob 0 from {len(ids)} of "
          f"{int(spec.NUMBER_OF_COLUMNS)} cells equals its extended cells: {recover_ms:.2f} ms, "
          f"{k9_launches} K9 launches at {sorted({str(k9.shapes(a)) for a, _ in k9.calls})}, "
          f"each held against its plain version on {card}")
    for k, v in err_more.items():
        err[k] = max(err.get(k, 0), v)
    err["fr_fft"] = err9
    # the kernels line names K8 g1_msm
    err["g1_msm"] = err.pop("msm_core")
    shapes["g1_msm"] = shapes.pop("msm_core")
    return {"launches": {k: launches[k] for k in path_kernels}, "err": err, "shapes": shapes,
            "k4_call": k4_args, "k4_ms": k4_ms, "shape_ms": shape_ms,
            "sidecar_launches": sidecar_launches,
            "sidecar_ms": sidecar_ms, "withheld_launches": withheld,
            "altered_k4_launches": altered_k4, "recover_ms": recover_ms,
            "k9_launches": k9_launches, "k9_shapes": sorted(k9.by_shape),
            "available_ms": ms["is_data_available"],
            "available_device_ms": sum(dev_clock.ms.values()),
            "transition_ms": ms["state_transition"], "flush_ms": ms["flush"],
            "on_block_ms": t_total, "withheld_on_block_ms": withheld_ms,
            "store": {k: v for k, v in fc.items() if k != "store"}, "votes": votes,
            "upgrade_s": up["upgrade_s"], "cold_s": up["cold_s"],
            "k18_launches": up["k18_launches"], "k18_err": up["k18_err"]}


# ---------------------------------------------------------------------------
# slice 6: the mesh engine on one card (epoch reductions and scans, span
# merkleization)
# ---------------------------------------------------------------------------

MESH_KERNELS = ("epoch_reduce", "incl_scan", "registry_scan")
MESH_REPLACES = {
    "epoch_reduce": "consensus_specs_tpu/parallel/mesh_epoch.py:151",
    "incl_scan": "consensus_specs_tpu/parallel/mesh_epoch.py:279",
    "registry_scan": "consensus_specs_tpu/parallel/mesh_epoch.py:504",
    "merkle_levels": "consensus_specs_tpu/parallel/mesh_merkle.py:62",
}
MERKLE_COUNTS = (2**14 - 1, 2**14, 2**14 + 1, 3 * 2**13 + 5)     # and the run's 2^20
FAR = 2**64 - 1
MASKS_ALONE = ("eligible", "active", "target")      # a K15 call no path makes
COLD_K5 = {1 << 20: 17}     # K5 launches of phase 6's cold root, at the default registry


def k18_expect(chunks) -> tuple:
    """(sorted leaf widths, K18 launches) of the span builds that trees of
    these leaf chunk counts take: those the span build engages (the floor),
    each padded to a power of two, one launch each."""
    from consensus_specs_tpu_torch.parallel import mesh_state
    widths = sorted(1 << (c - 1).bit_length() for c in chunks if mesh_state.merkle_engaged(c))
    return widths, len(widths)


def k18_check(tag: str, calls: list, launches: int, chunks) -> None:
    """Fail unless the recorded span builds are exactly those of
    :func:`k18_expect` (a tree that drops back to per-level K5 shows)."""
    widths, want = k18_expect(chunks)
    got = sorted(a[0].shape[0] for a, _ in calls)
    check(got == widths and launches == want,
          f"{tag}: K18 span builds at leaves {got} with {launches} launches, expected "
          f"{widths} with {want}")


def mesh_canon(torch, name):
    """The form in which a mesh kernel's outputs are compared: K17's
    defined part (``scan_defined``: without fill its buffers' tails are
    unspecified), every other output as it is."""
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    if name != "registry_scan":
        return None

    def defined(out):
        *prefixes, counts, active = me.scan_defined(out)
        return tuple(torch.from_numpy(x) for x in prefixes) \
            + (torch.from_numpy(counts), torch.tensor([active]))
    return defined


def mesh_plain() -> dict:
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
    return {"epoch_reduce": me.epoch_reduce_plain, "incl_scan": me.incl_scan_plain,
            "registry_scan": me.registry_scan_plain, "merkle_levels": mm.merkle_levels_plain}


def mesh_columns(np, n: int, spans: int, seed: int, every=False) -> dict:
    """Seeded registry columns of ``n`` lanes, zero-padded to a multiple of
    ``spans`` (pad lanes are zero, as the JAX placement pads them): FAR
    exit, withdrawable, activation and eligibility epochs, epochs 0-11
    around prev = 5 and cur = 6, slashed lanes, every flag combination,
    balances just under 2^63 and a FAR lane in the max columns.  ``every``:
    every lane an activation-queue candidate."""
    rng = np.random.default_rng(seed)
    gwei = 10**9
    roll = rng.random(n)
    c = {"eff": rng.integers(0, 33, n).astype(np.uint64) * np.uint64(gwei),
         "act": rng.integers(0, 8, n).astype(np.uint64),
         "ext": rng.integers(3, 12, n).astype(np.uint64),
         "aee": rng.integers(0, 8, n).astype(np.uint64),
         "sl": rng.random(n) < 0.2,
         "part": rng.integers(0, 8, n).astype(np.uint8),
         "bal": rng.integers(0, 2**62, n).astype(np.uint64),
         "scores": rng.integers(0, 2**40, n).astype(np.uint64)}
    c["wd"] = c["ext"] + rng.integers(0, 5, n).astype(np.uint64)
    c["ext"][roll < 0.5] = FAR
    c["wd"][roll < 0.45] = FAR
    c["act"][roll > 0.9] = FAR
    c["aee"][roll > 0.95] = FAR
    c["eff"][roll > 0.97] = 32 * gwei
    c["part"][:min(n, 8)] = np.arange(min(n, 8))
    c["bal"][:min(n, 2)] = 2**63 - 1 - np.arange(min(n, 2), dtype=np.uint64)
    c["scores"][n // 2] = FAR
    if every:
        c["aee"][:] = FAR
        c["eff"][:] = 32 * gwei
    pad = (-n) % spans
    return {k: np.concatenate([v, np.zeros(pad, dtype=v.dtype)]) for k, v in c.items()}


def mesh_kernel_checks(torch, dev, n_lanes: int) -> int:
    """K15 and K16 byte-identical to their plain versions on the card, at
    1, 1000 and ``n_lanes`` lanes with S = 1 and S = 4 (zero pad lanes), on
    seeded edge columns: FAR epochs, values just under 2^63 and FAR in the
    max columns, every flag combination, masks asked and not; K16 with
    duplicate indices (ties on the delay), pad (-1) and out-of-range
    entries and keys at and above 2^63 up to the sentinel; then K17
    (:func:`k17_edges`).  Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    err = 0
    for n in (1, 1000, n_lanes):
        for spans in (1, 4):
            c = mesh_columns(np, n, spans, seed=n + spans)
            t = {k: torch.from_numpy(v.view(np.int64) if v.dtype == np.uint64 else v).to(dev)
                 for k, v in c.items()}
            nn = t["eff"].shape[0]
            reg = {k: t[k] for k in ("eff", "act", "ext", "wd", "sl")}
            rows = torch.from_numpy(np.random.default_rng(n).random((3, nn)) < 0.5).to(dev)
            rows[:, n:] = False
            # the epoch engine's five calls (K15's dispatch set), two of
            # them again at the FAR epochs
            calls = [
                dict(reg=reg, max_cols=(t["eff"], t["scores"], t["bal"]), sums=True,
                     part=t["part"], n_flags=3, masks=("eligible", "active"), prev=5, cur=6),
                dict(reg=reg, max_cols=(t["eff"], t["bal"]), sums=True, rows=rows,
                     masks=("eligible",), prev=5, cur=6),
                dict(reg=reg, max_cols=(t["scores"],), masks=("eligible", "active"), prev=5),
                dict(reg=reg, max_cols=(t["eff"],), sums=True, masks=("target",), cur=6, tgt=7),
                dict(max_cols=(t["bal"], t["eff"])),
                dict(reg=reg, max_cols=(t["scores"],), masks=("eligible", "active"),
                     prev=FAR - 1),
                dict(reg=reg, max_cols=(t["eff"],), sums=True, masks=("target",), cur=FAR,
                     tgt=FAR),
            ]
            for i, kw in enumerate(calls):
                err = max(err, compare(torch, f"K15 (n={n}, S={spans}, call {i})",
                                       me.epoch_reduce(spans=spans, **kw),
                                       me.epoch_reduce_plain(spans=spans, **kw)))
            # a combination outside the dispatch set is refused, not run
            try:
                me.epoch_reduce(reg, masks=MASKS_ALONE, prev=5, cur=6, tgt=7, spans=spans)
            except RuntimeError:
                pass
            else:
                fail("K15 ran a call outside its dispatch set (the masks alone)")
            # K16: every lane once, then a third of them again at equal or
            # larger keys, pad and out-of-range entries, keys >= 2^63
            rng = np.random.default_rng(n * 7 + spans)
            idx = np.concatenate([rng.permutation(nn), rng.integers(0, nn, nn // 3 + 1),
                                  [-1, -1, nn, nn + 5]]).astype(np.int64)
            keys = (rng.integers(1, 5, idx.size).astype(np.uint64) << np.uint64(32)) \
                | rng.integers(0, 2048, idx.size).astype(np.uint64)
            keys[::97] = np.uint64(FAR)
            keys[5::101] = np.uint64(2**63 + 3)
            ti, tk = torch.from_numpy(idx).to(dev), torch.from_numpy(keys.view(np.int64)).to(dev)
            got = me.incl_scan(ti, tk, nn, spans)
            err = max(err, compare(torch, f"K16 (n={n}, S={spans})", got,
                                   me.incl_scan_plain(ti, tk, nn, spans)))
    torch.cuda.synchronize()
    print(f"kernel checks (small inputs): K15 (the epoch engine's five calls, two again at "
          f"the FAR epochs; the masks alone refused) and "
          f"K16 (duplicates, pads, out-of-range entries, keys >= 2^63 and the sentinel) "
          f"at n = 1, 1000, {n_lanes} with S = 1 and 4 byte-identical to their plain "
          f"versions on the card (tolerance 0: integers)")
    return max(err, k16_edges(torch, dev, n_lanes), k17_edges(torch, dev, n_lanes))


def k16_edges(torch, dev, n_lanes: int) -> int:
    """K16 byte-identical to its plain version on the card at odd lane
    counts (1, 7, 1001 and ``n_lanes`` + 1) and at ``n_lanes`` over 4
    spans, with m = 0, 1, 2, 3, 5 entries and three entries a lane (m = 3n
    and 3n + 1, odd); pad (-1), negative and out-of-range indices (n, n +
    5, 2^62); keys at and above 2^63 and the sentinel itself as a key; on
    idx and keys that start on their storage, both one entry in (a head
    entry before the 16-byte pairs) and idx alone one entry in (every
    entry one at a time).  Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    err, calls = 0, 0
    t0 = time.perf_counter()
    shapes = [(n, 1) for n in (1, 7, 1001, n_lanes + 1)] + [(n_lanes, 4)]
    for n, spans in shapes:
        for m in (0, 1, 2, 3, 5, 3 * n, 3 * n + 1):
            rng = np.random.default_rng(n * 11 + m)
            if m >= 3 * n:      # every lane three times, in a seeded order
                idx = rng.permutation(np.tile(np.arange(n, dtype=np.int64), 3))
                idx = np.concatenate([idx, rng.integers(0, n, m - 3 * n)])
            else:
                idx = rng.integers(0, n, m).astype(np.int64)
            bad = rng.random(m) < 0.05
            idx[bad] = rng.choice(np.array([-1, -7, n, n + 5, 2**62]), int(bad.sum()))
            keys = (rng.integers(1, 33, m).astype(np.uint64) << np.uint64(32)) \
                | rng.integers(0, 2048, m).astype(np.uint64)
            hi = rng.random(m) < 0.05
            keys[hi] = rng.integers(2**63, 2**64 - 1, int(hi.sum()), dtype=np.uint64)
            keys[rng.random(m) < 0.02] = np.uint64(FAR)
            big_i = torch.from_numpy(np.concatenate([[5], idx])).to(dev)
            big_k = torch.from_numpy(np.concatenate([np.array([7], dtype=np.uint64), keys])
                                     .view(np.int64)).to(dev)
            layouts = {"on their storage": (big_i[1:].clone(), big_k[1:].clone()),
                       "both one entry in": (big_i[1:], big_k[1:]),
                       "idx alone one entry in": (big_i[1:], big_k[1:].clone())}
            for lay, (ti, tk) in layouts.items():
                err = max(err, compare(torch, f"K16 (n={n}, S={spans}, m={m}, {lay})",
                                       me.incl_scan(ti, tk, n, spans),
                                       me.incl_scan_plain(ti, tk, n, spans)))
                calls += 1
    torch.cuda.synchronize()
    print(f"kernel checks: K16 at n = 1, 7, 1001, {n_lanes + 1} (S = 1) and {n_lanes} (S = 4) "
          f"with m = 0, 1, 2, 3, 5, 3n and 3n + 1 entries (three a lane), pads, negative and "
          f"out-of-range indices, keys >= 2^63 and the sentinel, idx and keys on their storage, "
          f"both one entry in and idx alone ({calls} calls) byte-identical to its plain version "
          f"on the card (tolerance 0: integers; {time.perf_counter() - t0:.1f} s)")
    return err


def k17_edges(torch, dev, n_lanes: int) -> int:
    """K17 byte-identical to its plain version on the card with S = 1, 2
    and 4 spans of 1, 1000, a tile's (2048) and a tile's plus one lanes,
    and ``n_lanes`` lanes in all; a family holding every lane and not;
    cap 256 (a count above the cap) and cap = the span's lanes; with fill
    and without it (the epoch engine's call: the counted prefixes, counts
    and active count).  Returns the largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    canon = mesh_canon(torch, "registry_scan")
    err, over = 0, 0
    t0 = time.perf_counter()
    shapes = [(n_local * spans, spans) for n_local in (1, 1000, me.SCAN_TILE, me.SCAN_TILE + 1)
              for spans in PROBE_K17_SPANS]
    shapes += [(n_lanes, spans) for spans in PROBE_K17_SPANS]
    for n, spans in shapes:
        for every in (False, True):
            cc = mesh_columns(np, n, spans, seed=n + 3, every=every)
            cols4 = tuple(torch.from_numpy(cc[k].view(np.int64)).to(dev)
                          for k in ("aee", "act", "ext", "eff"))
            nn = cols4[0].numel()
            for cap in (256, nn // spans):
                kw = dict(cur=6, finalized=4, far=FAR, max_eb=32 * 10**9,
                          ejection=16 * 10**9, cap=cap, spans=spans)
                tag = f"n={n}, S={spans}, cap={cap}, every={every}"
                want = me.registry_scan_plain(*cols4, **kw)
                got = me.registry_scan(*cols4, **kw)
                err = max(err, compare(torch, f"K17 ({tag})", got, want))
                err = max(err, compare(torch, f"K17 without fill ({tag})",
                                       canon(me.registry_scan(*cols4, fill=False, **kw)),
                                       canon(want)))
                over += int((want.counts > cap).any())
                if every:
                    check(int(got.counts[0].sum()) == n,
                          "K17: every lane must be a queue candidate")
    check(over > 0, "K17's edge inputs must hold a count above the cap")
    torch.cuda.synchronize()
    print(f"kernel checks: K17 at S = 1, 2, 4 spans of 1, 1000, {me.SCAN_TILE} and "
          f"{me.SCAN_TILE + 1} lanes and at {n_lanes} lanes, every lane a candidate and not, "
          f"cap 256 ({over} calls with a count above it) and the span's lanes, with and "
          f"without fill, byte-identical to its plain version on the card (tolerance 0: "
          f"integers; {time.perf_counter() - t0:.1f} s)")
    return err


def sequential_tree(merkle, raw: bytes):
    """A tree of ``raw`` built level by level with hashlib alone."""
    saved = (merkle._batched_hasher, merkle._batched_hasher_np)
    merkle.set_batched_hasher(None)
    merkle.set_batched_hasher_np(None)
    try:
        return merkle.IncrementalTree(raw, 2**40)
    finally:
        merkle.set_batched_hasher(saved[0])
        merkle.set_batched_hasher_np(saved[1])


def merkle_checks(torch, dev, n_lanes: int) -> int:
    """K18 byte-identical to its plain version on the card and every level
    to hashlib, on leaf layers of 2^14 - 1, 2^14, 2^14 + 1, 3 x 2^13 + 5 and
    ``n_lanes`` seeded chunks (zero-padded to a power of two) with S = 1
    and S = 4; ``IncrementalTree`` through the span build equal to the
    sequential hashlib build, and equal to a fresh build after an
    incremental update; a span build below 2 x S declines.  Returns the
    largest word difference (0)."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
    from consensus_specs_tpu_torch.parallel import mesh_state
    from consensus_specs_tpu_torch.utils.ssz import merkle
    err = 0
    sha256.install_merkle_hasher(dev)
    mesh_state.use_mesh()               # below the floor too
    t0 = time.perf_counter()
    for count in MERKLE_COUNTS + (n_lanes,):
        width = merkle.next_power_of_two(count)
        raw = hashlib.shake_256(SEED + b"leaves" + count.to_bytes(4, "little")).digest(32 * count)
        leaves = np.zeros(32 * width, dtype=np.uint8)
        leaves[:32 * count] = np.frombuffer(raw, dtype=np.uint8)
        want, level = [], leaves.tobytes()
        while len(level) > 32:
            level = b"".join(hashlib.sha256(level[i:i + 64]).digest()
                             for i in range(0, len(level), 64))
            want.append(level)
        t = torch.from_numpy(leaves.reshape(width, 32)).to(dev)
        seq = [bytes(x) for x in sequential_tree(merkle, raw).levels]
        for spans in (1, 4):
            got = mm.merkle_levels(t, spans)
            err = max(err, compare(torch, f"K18 (count={count}, S={spans})", got,
                                   mm.merkle_levels_plain(t, spans)))
            depth = (width // spans).bit_length() - 1
            check(got.cpu().numpy().tobytes() == b"".join(want[:depth]),
                  f"K18 differs from hashlib (count={count}, S={spans})")
            levels = mm.build_levels(raw, 40, spans)
            check(levels is not None and [bytes(x) for x in levels] == seq,
                  f"build_levels differs from the sequential build (count={count}, S={spans})")
    check(mm.build_levels(b"\x01" * 32 * 3, 40, 4) is None,
          "a span build below 2 x S must decline")
    # every width the main path launches (2^14 to 2^20 leaves: the
    # wrapper's plans) against the plain version (once a width: the levels
    # of S spans are the first N - S of one span's) and hashlib, and
    # depths 1 to 14 with CTAs of 32 to 512 threads (one to four tiers,
    # depths off every tier's multiple; the first tier folding k - 5 and k
    # levels, as launch_plan picks) against hashlib
    cases = [(1 << d, s, None, None) for d in range(14, (n_lanes - 1).bit_length() + 1)
             for s in (1, 2, 4)]
    for t in (32, 64, 128, 256, 512):
        k = (2 * t).bit_length() - 1
        cases += [(s << d, s, t, f) for d in range(1, 15) for s in (1, 2, 4)
                  for f in ((k - mm.LOG_KEEP, k) if d > k else (k,))]
    levels = {}
    for n, spans, threads, first in cases:
        if n not in levels:
            leaves = hashlib.shake_256(SEED + b"widths" + n.to_bytes(4, "little")).digest(32 * n)
            want, level = [], leaves
            while len(level) > 32:
                level = b"".join(hashlib.sha256(level[i:i + 64]).digest()
                                 for i in range(0, len(level), 64))
                want.append(level)
            t = torch.frombuffer(bytearray(leaves), dtype=torch.uint8).view(n, 32).to(dev)
            levels[n] = (t, want, None)
        t, want, plain = levels[n]
        depth = mm.merkle_levels_chain(n, spans)
        th, plan = (threads, mm.tiers(depth, threads, first)) if threads \
            else mm.launch_plan(n, depth)
        got = mm._launch(t, th, plan) if threads else mm.merkle_levels(t, spans)
        tag = f"{n} leaves, S={spans}, {th} threads, tiers {plan}"
        if threads is None:
            if plain is None:
                plain = mm.merkle_levels_plain(t)
                levels[n] = (t, want, plain)
            err = max(err, compare(torch, f"K18 ({tag})", got, plain[:n - spans]))
        check(got.cpu().numpy().tobytes() == b"".join(want[:depth]),
              f"K18 differs from hashlib ({tag})")
    del levels
    # the routed tree, updated after its span build, equals a fresh build
    count = MERKLE_COUNTS[2]
    raw = bytearray(hashlib.shake_256(SEED + b"update").digest(32 * count))
    tree = merkle.IncrementalTree(bytes(raw), 2**40)
    update = {7: b"\x11" * 32, count - 1: b"\x22" * 32, count: b"\x33" * 32}
    tree.rehash_up(tree.apply_leaves(update))
    raw[32 * 7:32 * 8] = update[7]
    raw[32 * (count - 1):32 * count] = update[count - 1]
    raw += update[count]
    check([bytes(x) for x in tree.levels]
          == [bytes(x) for x in sequential_tree(merkle, bytes(raw)).levels],
          "an IncrementalTree updated after a span build differs from a fresh build")
    mesh_state.use_auto()
    torch.cuda.synchronize()
    print(f"kernel checks: K18 at {list(MERKLE_COUNTS) + [n_lanes]} leaves, S = 1 and 4, at "
          f"2^14 to 2^{(n_lanes - 1).bit_length()} leaves with S = 1, 2 and 4 (the wrapper's "
          f"plans), byte-identical to its plain version on the card and every level to "
          f"hashlib, and at depths 1 to 14 with S = 1, 2 and 4 and CTAs of 32 to 512 threads "
          f"equal to hashlib; "
          f"build_levels equal to the sequential build; an updated span-built tree equal to a "
          f"fresh build ({time.perf_counter() - t0:.1f} s)")
    return err


def mesh_bound(name, args, kw) -> tuple:
    """(bytes, operations) that one recorded call's data needs."""
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
    if name == "epoch_reduce":
        reg = args[0] if args else kw.get("reg")
        cols = kw.get("max_cols", ())
        n = (next(iter(reg.values())) if reg else cols[0]).numel()
        rows = kw.get("rows")
        k = kw.get("n_flags", 0) if kw.get("part") is not None \
            else (rows.shape[0] if rows is not None else 0)
        sums, masks = kw.get("sums", False), kw.get("masks", ())
        return (me.epoch_reduce_bytes(n, sums=sums, flags=kw.get("part") is not None, k=k,
                                      max_cols=me.epoch_reduce_names(reg, cols), masks=masks),
                me.epoch_reduce_ops(n, sums=sums, k=k, n_max=len(cols), masks=masks))
    if name == "incl_scan":
        m, n = args[0].numel(), args[2]
        return me.incl_scan_bytes(m, n), me.incl_scan_ops(m, n)
    if name == "registry_scan":
        # the slots this run's data needs: without fill, the candidates
        n, cap, spans = args[0].numel(), kw["cap"], kw.get("spans", 1)
        counts = me.registry_scan_plain(*args, **kw).counts.cpu().numpy()
        slots = me.registry_scan_slots(counts, cap, kw.get("fill", True))
        return me.registry_scan_bytes(n, spans, slots), me.registry_scan_ops(n, slots)
    rows, spans = args[0].shape[0], args[1] if len(args) > 1 else 1
    return (mm.merkle_levels_bytes(rows, spans, rows), mm.merkle_levels_ops(rows, spans, rows))


def mesh_entry(torch, card, name, call, launches: dict, err: int, library=None,
               extra=None) -> dict:
    """One ``kernels`` line entry: ``call`` = (args, kwargs) of a recorded
    main-path call, timed per launch queued ahead; ``library``: one
    PyTorch call of the same function on the same inputs, or None."""
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
    args, kw = call
    fn = getattr(mm if name == "merkle_levels" else me, name)
    ms = queued_ms(torch, lambda: fn(*args, **kw))
    p_ms = plain_ms(torch, lambda: mesh_plain()[name](*args, **kw))
    lib_ms = queued_ms(torch, library) if library is not None else None
    nbytes, ops = mesh_bound(name, args, kw)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    entry = {"name": name, "route": "cuda",
             "source": "consensus_specs_tpu_torch/csrc/"
             + ("mesh_merkle.cu" if name == "merkle_levels" else "mesh.cu"),
             "replaces": MESH_REPLACES[name], "launches": sum(launches.values()),
             "launches_by_path": launches, "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
             "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
             "library_ms": lib_ms, "bytes": nbytes, "ops": ops}
    entry.update(extra or {})
    per = "per launch" if name != "merkle_levels" else "per call (one launch)"
    print(f"time {name}: {ms:.4f} ms {per} queued ahead (plain on the card {p_ms:.3f} ms, "
          f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
          f"{max(b_ms, o_ms):.5f} ms: bytes {nbytes} -> {b_ms:.5f} ms, operations {ops} -> "
          f"{o_ms:.5f} ms); launches {launches} on {card}")
    return entry


def mesh_entries(torch, card, run: dict, merkle_calls: list, launches: dict, err: dict) -> list:
    """The ``kernels`` line's K15-K18 entries, at the main path's calls:
    K15 at the phase0 leaking epoch's max-only call (the effective
    balances; library: ``torch.amax`` over the stacked columns) with its
    rewards call (sums, maxima and the eligibility mask) timed beside;
    K16 and K17 at that epoch's calls (library: ``scatter_reduce_`` amin
    on a prefilled column; ``torch.nonzero`` of each family's mask); K18
    at the largest call of phase 6's cold root (library: none).  ``run``:
    phase 10's leaking run; ``launches``: {kernel: {path: launches}}."""
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
    out = []
    calls = run["calls"]["epoch_reduce"]
    kws = run["kwargs"]["epoch_reduce"]
    max_call = next((a, k) for a, k in zip((c[0] for c in calls), kws) if not k.get("sums"))
    sum_call = next((a, k) for a, k in zip((c[0] for c in calls), kws) if k.get("sums"))
    stacked = torch.stack(max_call[1]["max_cols"])
    s_ms = queued_ms(torch, lambda: me.epoch_reduce(*sum_call[0], **sum_call[1]))
    s_bytes, s_ops = mesh_bound("epoch_reduce", *sum_call)
    empty_ms = queued_ms(torch, lambda: torch.cuda._sleep(0))
    out.append(mesh_entry(torch, card, "epoch_reduce", max_call, launches["epoch_reduce"],
                          err["epoch_reduce"], lambda: torch.amax(stacked, dim=1),
                          {"sum_mode_ms": s_ms,
                           "sum_mode_bound_ms":
                           max(s_bytes / HBM_BYTES_PER_S, s_ops / INT32_OPS_PER_S) * 1e3,
                           "empty_launch_ms": empty_ms}))
    print(f"time epoch_reduce (the rewards call: sums, maxima, the eligibility mask): "
          f"{s_ms:.4f} ms per launch queued ahead; an empty launch (torch.cuda._sleep(0)) "
          f"{empty_ms:.5f} ms queued ahead on {card}")
    args, kw = run["calls"]["incl_scan"][0][0], run["kwargs"]["incl_scan"][0]
    base = torch.full((args[2],), 2**63 - 1, dtype=torch.int64, device=args[0].device)
    # the fill alone: the same lanes and no entry
    fill_ms = queued_ms(torch, lambda: me.incl_scan(args[0][:0], args[1][:0], *args[2:], **kw))
    out.append(mesh_entry(torch, card, "incl_scan", (args, kw), launches["incl_scan"],
                          err["incl_scan"],
                          lambda: base.scatter_reduce_(0, args[0], args[1], "amin"),
                          {"fill_alone_ms": fill_ms, "entries": int(args[0].numel())}))
    print(f"time incl_scan, its fill alone (no entry, {args[2]} lanes): {fill_ms:.4f} ms per "
          f"launch queued ahead on {card}")
    args, kw = run["calls"]["registry_scan"][0][0], run["kwargs"]["registry_scan"][0]
    fams = me.registry_families_plain(*args, **{k: v for k, v in kw.items()
                                               if k not in ("cap", "spans", "fill")})[:3]
    out.append(mesh_entry(torch, card, "registry_scan", (args, kw), launches["registry_scan"],
                          err["registry_scan"], lambda: [torch.nonzero(f) for f in fams]))
    big = max(merkle_calls, key=lambda c: c[0][0].shape[0])
    rows = int(big[0][0].shape[0])
    # the launches of one call, counted: the counter is zeroed, the call
    # made once untimed, and the counter read after it
    _build.launches["merkle_levels"] = 0
    mm.merkle_levels(*big[0])
    torch.cuda.synchronize()
    per_call = _build.launches["merkle_levels"]
    _build.launches["merkle_levels"] = 0
    check(per_call == 1, f"K18: one launch a tree, but the timed call made {per_call}")
    out.append(mesh_entry(torch, card, "merkle_levels", (big[0], {}), launches["merkle_levels"],
                          err["merkle_levels"], None,
                          {"leaves": rows, "ms_is_per": "call", "launches_per_call": per_call,
                           "chain_hashes": mm.merkle_levels_chain(rows)}))
    return out


# ---------------------------------------------------------------------------
# --probe: K3, K2, K7, K4, K8 and K15 timed through their wrappers; the
# engine sweep
# ---------------------------------------------------------------------------

PROBE_POINTS = 4096
PROBE_K8_SHAPES = (("commit", 4096), ("cell", 4032), ("verify", 6))
SWEEP_VALIDATORS = (1 << 12, 1 << 14, 1 << 16)     # around the mesh floor (2^16)
SWEEP_KEYS = 64                                     # registry keys the sweep's states cycle over


def probe_k8(torch, dev) -> dict:
    """K8 on K7's table of 4096 seeded points P_i = A + i B with uniform
    scalars below r, at the commitment, cell and verify shapes: device ms
    per call queued ahead and back to back from the host, and per stage
    where the tree has ``msm_core_stage_ms``.  The verify shape is held
    against the plain version first."""
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import msm
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    r = K.BLS_MODULUS
    a, b = (G1_GENERATOR.mult(v) for v in field_elements(b"probe-k8", 2, r))
    pts, p = [], a
    for _ in range(PROBE_POINTS):
        pts.append(p)
        p = p + b
    aff, inf = (t.to(dev) for t in C.pack_g1(pts))
    win = msm.expand_windows(aff, inf)
    scalars = field_elements(b"probe-k8-scalars", PROBE_POINTS, r)
    out = {}
    for tag, n in PROBE_K8_SHAPES:
        w = win[:, :n].contiguous()
        sc = msm.scalar_words(scalars[:n]).to(dev)
        if tag == "verify":
            compare(torch, "K8 (probe, verify shape)", msm.msm_core(w, sc),
                    msm.msm_core_plain(w, sc))
        out[tag] = {"points": n, "queued_ms": queued_ms(torch, lambda: msm.msm_core(w, sc), 10),
                    "host_ms": cuda_ms(torch, lambda: msm.msm_core(w, sc), 5)}
        if hasattr(msm, "msm_core_stage_ms"):
            out[tag]["stages_ms"] = msm.msm_core_stage_ms(w, sc)
    return out


PROBE_K7_POINTS = (2, 6, 48, 64, 4032, 4096)     # every K7 shape of phases 8-9
PROBE_K4_SHAPES = (("block flush", 132, 1), ("per-lane batch", 262, 131),
                   ("blob and cell batch verify", 2, 1))


def probe_k7(torch, dev) -> dict:
    """K7 at every shape phases 8-9 launch, on seeded points P_i = A + i B
    (the first at infinity): device ms per call queued ahead; the
    6-point call held against the plain version first."""
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import msm
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR, G1Point
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    a, b = (G1_GENERATOR.mult(v) for v in field_elements(b"probe-k7", 2, K.BLS_MODULUS))
    pts, p = [G1Point.inf()], a
    while len(pts) < max(PROBE_K7_POINTS):
        pts.append(p)
        p = p + b
    out = {}
    for n in PROBE_K7_POINTS:
        aff, inf = (t.to(dev) for t in C.pack_g1(pts[:n]))
        if n == 6:
            compare(torch, "K7 (probe, N = 6)", msm.expand_windows(aff, inf),
                    msm.expand_windows_plain(aff, inf))
        out[n] = queued_ms(torch, lambda: msm.expand_windows(aff, inf), 10)
    return out


def probe_k4(torch, dev) -> dict:
    """K4 at the paths' shapes (pairs, groups) on seeded pairs ([a_i] G1,
    [b_i] G2) whose groups multiply to one, so every verdict is True:
    device ms per call queued ahead; the 2-pair call held against the
    plain version first."""
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR, G2_GENERATOR
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    from consensus_specs_tpu_torch.ops.torch_bls import pairing
    r = 2 ** 64
    xs = field_elements(b"probe-k4", 8, r)
    g1 = [G1_GENERATOR.mult(x) for x in xs]
    g2 = [G2_GENERATOR.mult(x) for x in xs]
    out = {}
    for tag, n, groups in PROBE_K4_SHAPES:
        ps, qs = [], []
        for i in range(n // 2):          # e([x]G1, [y]G2) e(-[y]G1, [x]G2) = 1
            x, y = i % 8, (i + 3) % 8
            ps += [g1[x], -g1[y]]
            qs += [g2[y], g2[x]]
        if n % 2:
            ps.append(g1[0])
            qs.append(g2[0])
        per = n // groups
        off = torch.tensor([min(g * per, n) for g in range(groups)] + [n], dtype=torch.int32)
        args = (C.pack_g1(ps)[0].to(dev), C.pack_g2(qs)[0].to(dev),
                torch.zeros(n, dtype=torch.bool, device=dev), off)
        if n == 2:
            compare(torch, "K4 (probe, 2 pairs)", pairing.pairing_check(*args),
                    pairing.pairing_check_plain(*args))
        out[tag] = {"pairs": n, "groups": groups,
                    "queued_ms": queued_ms(torch, lambda: pairing.pairing_check(*args), 5)}
    return out


PROBE_K3_SHAPES = ((4, "phase 2"), (16, "AggregateVerify"), (130, "phase0 block"),
                   (131, "block flush, per-lane batch, Altair block"))
PROBE_K2_SHAPES = ((4, "phase 2"), (130, "phase0 block"), (131, "block flush, Altair block"))


def probe_k3(torch, dev) -> dict:
    """K3 at every message count the paths launch it with, on seeded
    messages: each call held against the plain version first, then
    device ms per call queued ahead."""
    from consensus_specs_tpu_torch.ops.torch_bls import htc
    msgs = [hashlib.sha256(b"probe-k3" + i.to_bytes(4, "little")).digest() for i in range(131)]
    u = htc.hash_to_field_host(msgs).to(dev)
    out = {}
    for n, tag in PROBE_K3_SHAPES:
        un = u[:n].contiguous()
        compare(torch, f"K3 (probe, {n} messages)", htc.hash_to_g2(un), htc.hash_to_g2_plain(un))
        out[n] = {"path": tag, "queued_ms": queued_ms(torch, lambda: htc.hash_to_g2(un), 10)}
    return out


def probe_k2(torch, dev) -> dict:
    """K2 at every lane count the paths launch it with, on seeded
    signatures [a_i] G2 and uniform 128-bit scalars: each call held
    against the plain version first, then device ms per call queued
    ahead."""
    import numpy as np
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G2_GENERATOR
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    from consensus_specs_tpu_torch.ops.torch_bls import points
    gs = [G2_GENERATOR.mult(v) for v in field_elements(b"probe-k2", 8, 1 << 64)]
    scalars = field_elements(b"probe-k2-scalars", 131, 1 << 128)
    sig, sig_inf = (t.to(dev) for t in C.pack_g2([gs[i % 8] for i in range(131)]))
    raw = b"".join(v.to_bytes(16, "little") for v in scalars)
    sc = torch.from_numpy(np.frombuffer(raw, dtype=np.int32).reshape(131, 4).copy()).to(dev)
    out = {}
    for n, tag in PROBE_K2_SHAPES:
        args = (sig[:n].contiguous(), sig_inf[:n].contiguous(), sc[:n].contiguous())
        compare(torch, f"K2 (probe, {n} lanes)", points.g2_scale_sum(*args),
                points.g2_scale_sum_plain(*args))
        out[n] = {"path": tag, "queued_ms": queued_ms(torch, lambda: points.g2_scale_sum(*args),
                                                      10)}
    return out


PROBE_K1_SHAPES = ((4, "phase 2"), (130, "phase0 block"),
                   (131, "block flush, per-lane batch, Altair block"))
PROBE_K18_WIDTHS = (1 << 14, 1 << 16, 1 << 18, 1 << 20)


def probe_k1(torch, dev) -> dict:
    """K1 at every row count the paths launch it with, on rows of 512 keys
    (64 seeded keys [a_i] G1 cycled; the last two rows of one key, as a
    block's proposer and randao items), with uniform 128-bit scalars (the
    flush, the blocks) and without (the per-lane batch): each call held
    against the plain version first, then device ms per call queued
    ahead."""
    import numpy as np
    from consensus_specs_tpu_torch.ops.bls12_381.curve import G1_GENERATOR
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    from consensus_specs_tpu_torch.ops.torch_bls import points
    keys = C.pack_g1([G1_GENERATOR.mult(v) for v in field_elements(b"probe-k1", 64, 1 << 64)])[0]
    pk = keys[torch.arange(131 * COMMITTEE) % 64].view(131, COMMITTEE, 2, 12).to(dev)
    raw = b"".join(v.to_bytes(16, "little") for v in field_elements(b"probe-k1-scalars", 131,
                                                                      1 << 128))
    sc = torch.from_numpy(np.frombuffer(raw, dtype=np.int32).reshape(131, 4).copy()).to(dev)
    out = {}
    for n, tag in PROBE_K1_SHAPES:
        cnt = torch.full((n,), COMMITTEE, dtype=torch.int32)
        cnt[-2:] = 1
        for scaled in (True, False):
            args = (pk[:n].contiguous(), cnt, sc[:n].contiguous() if scaled else None)
            compare(torch, f"K1 (probe, {n} rows, scalars {scaled})",
                    points.g1_aggregate_scale(*args), points.g1_aggregate_scale_plain(*args))
            out[f"{n} {'scaled' if scaled else 'sum'}"] = {
                "path": tag, "queued_ms": queued_ms(torch,
                                                    lambda: points.g1_aggregate_scale(*args), 10)}
    return out


def probe_k18(torch, dev) -> dict:
    """K18 on seeded leaves at 2^14, 2^16, 2^18 and 2^20 chunks (the widths
    of the cold roots' and the commits' trees), one span: each call held
    against the plain version first, then device ms per call queued ahead
    (the counters' zeroing included); where the wrapper takes a CTA size
    (``_launch``), its plan and, each equal to the wrapper's output, CTAs
    of 64 to 512 threads with the first tier folding k - 5 and k levels,
    and a ``torch.zeros`` of 129 counters alone."""
    from consensus_specs_tpu_torch.parallel import mesh_merkle as mm
    out = {}
    for n in PROBE_K18_WIDTHS:
        raw = hashlib.shake_256(SEED + b"probe-k18" + n.to_bytes(4, "little")).digest(32 * n)
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(n, 32).to(dev)
        got = mm.merkle_levels(t)
        compare(torch, f"K18 (probe, {n} leaves)", got, mm.merkle_levels_plain(t))
        out[n] = {"queued_ms": queued_ms(torch, lambda: mm.merkle_levels(t), 20)}
        if not hasattr(mm, "_launch"):
            continue
        depth = n.bit_length() - 1
        th, plan = mm.launch_plan(n, depth)
        out[n].update(threads=th, plan=plan)
        for th in (64, 128, 256, 512):
            k = (2 * th).bit_length() - 1
            for first in (k - mm.LOG_KEEP, k):
                plan = mm.tiers(depth, th, first)
                compare(torch, f"K18 (probe, {n} leaves, {th} threads, plan {plan})",
                        mm._launch(t, th, plan), got)
                out[n][f"ms_{th}_{first}"] = queued_ms(
                    torch, lambda: mm._launch(t, th, plan), 20)
        out[n]["zeros_ms"] = queued_ms(torch, lambda: torch.zeros((129,), dtype=torch.int32,
                                                                  device=dev), 20)
    return out


def probe_k15(torch, dev) -> dict:
    """K15 on seeded 2^20-lane registry columns, one span, at the epoch
    engine's effective-balance call (maxima alone) and its phase0 and
    Altair rewards calls, each held against the plain version first;
    beside them ``torch.amax`` over the max-only call's stacked columns and
    an empty launch.  Device ms per call, queued ahead."""
    import numpy as np
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    c = mesh_columns(np, VALIDATORS, 1, seed=11)
    t = {k: torch.from_numpy(v.view(np.int64) if v.dtype == np.uint64 else v).to(dev)
         for k, v in c.items()}
    rows = torch.from_numpy(np.random.default_rng(11).random((3, VALIDATORS)) < 0.5).to(dev)
    reg = {k: t[k] for k in ("eff", "act", "ext", "wd", "sl")}
    calls = {
        "max mode (effective balances)": dict(max_cols=(t["bal"], t["eff"])),
        "phase0 rewards": dict(reg=reg, max_cols=(t["eff"], t["bal"]), sums=True, rows=rows,
                               masks=("eligible",), prev=5, cur=6),
        "Altair rewards": dict(reg=reg, max_cols=(t["eff"], t["scores"], t["bal"]), sums=True,
                               part=t["part"], n_flags=3, masks=("eligible", "active"), prev=5,
                               cur=6),
    }
    out = {}
    for name, kw in calls.items():
        compare(torch, f"K15 (probe, {name})", me.epoch_reduce(**kw), me.epoch_reduce_plain(**kw))
        out[name] = queued_ms(torch, lambda: me.epoch_reduce(**kw), 50)
    stacked = torch.stack((t["bal"], t["eff"]))
    out["torch.amax (max mode's columns)"] = queued_ms(torch, lambda: torch.amax(stacked, dim=1),
                                                       50)
    out["empty launch (torch.cuda._sleep(0))"] = queued_ms(torch, lambda: torch.cuda._sleep(0), 50)
    return out


PROBE_K9_SHAPES = ((6, 8192), (6, 16), (6, 64), (6, 4096))   # (rows, n); (6, 8192): recovery
PROBE_K9_ROWS = (1, 2, 12, 24)
PROBE_K17_SPANS = (1, 2, 4)


def k9_inputs(torch, dev, rows: int, n: int, inv: bool, tag: bytes = b"") -> tuple:
    """Seeded (rows, n, 8) canonical words (0, 1 and r - 1 first) and the
    (n/2, 8) Montgomery twiddles of the forward or inverse domain."""
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops.torch_bls import fr as F
    r = K.BLS_MODULUS
    roots = list(K.compute_roots_of_unity(n))
    domain = roots[0:1] + roots[:0:-1] if inv else roots
    vals = field_elements(b"k9" + tag + bytes([rows, inv]) + n.to_bytes(4, "little"),
                          rows * n, r)
    vals[:3] = [0, 1, r - 1][:len(vals[:3])]
    words = torch.from_numpy(F.words_from_ints(vals).reshape(rows, n, F.WORDS).copy())
    tw = torch.from_numpy(F.words_from_ints(domain[:n // 2], mont_form=True).copy())
    return words.to(dev), tw.to(dev)


def probe_k9(torch, dev) -> dict:
    """K9 at :data:`PROBE_K9_SHAPES`, forward and inverse: a whole
    transform held against the plain version first, then device ms per
    transform queued ahead; every cluster size at the recovery's (6, 8192)
    beside the wrapper's plan; and (rows, 8192) forward at
    :data:`PROBE_K9_ROWS` rows."""
    from consensus_specs_tpu_torch.ops import fr_fft
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for rows, n in PROBE_K9_SHAPES:
        for inv in (False, True):
            vals, tw = k9_inputs(torch, dev, rows, n, inv)
            tag = f"({rows}, {n}) {'inverse' if inv else 'forward'}"
            want = fr_fft.fr_fft_plain(vals, tw)
            compare(torch, f"K9 (probe, {tag})", fr_fft.fr_fft(vals, tw), want)
            out[tag] = {"queued_ms": queued_ms(torch, lambda: fr_fft.fr_fft(vals, tw), 20)}
            if (rows, n) != PROBE_K9_SHAPES[0]:
                continue
            out[tag]["plan"] = list(fr_fft.launch_plan(n, rows, sms))
            for cluster in (2, 4, 8, 16):
                tile = n // cluster
                for threads in sorted({min(256, max(32, tile // 2)), 128}):
                    plan = (cluster, tile, threads)
                    compare(torch, f"K9 (probe, {tag}, plan {plan})",
                            fr_fft._launch(vals, tw, plan), want)
                    out[tag][f"ms_{cluster}_{threads}"] = queued_ms(
                        torch, lambda: fr_fft._launch(vals, tw, plan), 20)
    # the batch's rows: flat while the clusters leave SMs idle?
    for rows in PROBE_K9_ROWS:
        vals, tw = k9_inputs(torch, dev, rows, 8192, False, b"rows")
        out[f"({rows}, 8192) forward"] = {
            "queued_ms": queued_ms(torch, lambda: fr_fft.fr_fft(vals, tw), 20)}
    return out


def k17_call(torch, dev, n: int, spans: int, seed: int) -> tuple:
    """Seeded registry columns of ``n`` lanes over ``spans`` spans and the
    epoch engine's call on them (cap = the span's lanes, no fill)."""
    import numpy as np
    c = mesh_columns(np, n, spans, seed=seed)
    cols = tuple(torch.from_numpy(c[k].view(np.int64)).to(dev) for k in ("aee", "act", "ext", "eff"))
    kw = dict(cur=6, finalized=4, far=FAR, max_eb=32 * 10**9, ejection=16 * 10**9,
              cap=cols[0].numel() // spans, spans=spans, fill=False)
    return cols, kw


def probe_k17(torch, dev) -> dict:
    """K17 on seeded 2^20-lane registry columns at 1, 2 and 4 spans, the
    epoch engine's call form (cap = the span's lanes, no fill), and at one
    span with fill: each held against the plain version first (its
    defined part), then device ms per call queued ahead; beside them
    ``torch.nonzero`` of the three family masks."""
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    canon = mesh_canon(torch, "registry_scan")
    out = {}
    for spans in PROBE_K17_SPANS:
        cols, kw = k17_call(torch, dev, VALIDATORS, spans, seed=17 + spans)
        for fill in ((False, True) if spans == 1 else (False,)):
            kw["fill"] = fill
            tag = f"2^20 lanes, S={spans}" + (", fill" if fill else "")
            want = me.registry_scan_plain(*cols, **kw)
            got = me.registry_scan(*cols, **kw)
            compare(torch, f"K17 (probe, {tag})", canon(got), canon(want))
            if fill:
                compare(torch, f"K17 (probe, {tag}, every slot)", got, want)
            out[tag] = queued_ms(torch, lambda: me.registry_scan(*cols, **kw), 50)
        if spans == 1:
            fams = me.registry_families_plain(*cols, **{k: v for k, v in kw.items()
                                                        if k not in ("cap", "spans", "fill")})[:3]
            out["torch.nonzero (the three families, S=1)"] = queued_ms(
                torch, lambda: [torch.nonzero(f) for f in fams], 50)
    return out


def probe_epoch(torch, dev) -> dict:
    """K10-K14 and K16 on seeded 2^20-lane columns in a leak (the leaking
    runs' call forms: K10-K12 phase0's, K13-K14 Altair's, K16 one
    inclusion entry a lane), K13 also not leaking, and K16's fill alone
    (no entry), its scatter (the call less the fill) and the call on the
    same entries in lane order, each call held against its plain version
    first; device ms per call queued ahead."""
    import numpy as np
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    from consensus_specs_tpu_torch.parallel import mesh_epoch as me
    n, gwei = VALIDATORS, 10**9
    rng = np.random.default_rng(10)
    t = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("bal", rng.integers(0, 40 * gwei, n, dtype=np.int64)),
        ("eff", rng.integers(0, 33, n, dtype=np.int64) * gwei),
        ("incl", rng.integers(0, 2**25, n, dtype=np.int64)),
        ("scores", rng.integers(0, 100, n, dtype=np.int64)),
        ("part", rng.integers(0, 8, n).astype(np.uint8)),
        ("elig", rng.random(n) < 0.8), ("active", rng.random(n) < 0.85),
        ("target", rng.random(n) < 0.1), ("att", rng.random((3, n)) < 0.6))}
    total = int(t["eff"].sum())
    brpi = 64 * gwei // int(np.sqrt(total))
    calls = {
        "K10 phase0_deltas": (ek.phase0_deltas, ek.phase0_deltas_plain, (
            t["eff"], t["incl"], t["bal"], t["elig"], t["att"],
            ek.Phase0Scalars(64, int(np.sqrt(total)), 4, tuple(
                max(1, int(t["eff"][a].sum()) // gwei) for a in t["att"]), total // gwei,
                True, 8, 5, 2**26))),
        "K11 effective_balance": (ek.effective_balance, ek.effective_balance_plain, (
            t["bal"], t["eff"], gwei, gwei // 4, 5 * gwei // 4, 32 * gwei)),
        "K12 slashings": (ek.slashings, ek.slashings_plain, (
            t["eff"], t["bal"], t["target"], gwei, total // 2, total)),
        "K13 altair_deltas": (ek.altair_deltas, ek.altair_deltas_plain, (
            t["eff"], t["bal"], t["scores"], t["part"], t["elig"], t["active"],
            ek.AltairScalars(gwei, brpi, (14, 26, 14), (n // 3, n // 2, n // 4),
                             total // gwei, 64, True, 4 * 50331648))),
        "K14 inactivity_updates": (ek.inactivity_updates, ek.inactivity_updates_plain, (
            t["scores"], t["part"], t["elig"], t["active"], 4, 16, True)),
    }
    k13 = calls["K13 altair_deltas"][2]
    calls["K13 altair_deltas (not leaking)"] = (ek.altair_deltas, ek.altair_deltas_plain,
                                                k13[:-1] + (k13[-1]._replace(in_leak=False),))
    idx = torch.from_numpy(rng.permutation(n).astype(np.int64)).to(dev)
    keys = torch.from_numpy((rng.integers(1, 33, n).astype(np.int64) << 32)
                            | rng.integers(0, 2048, n).astype(np.int64)).to(dev)
    calls["K16 incl_scan"] = (me.incl_scan, me.incl_scan_plain, (idx, keys, n))
    # the same entries in lane order: the atomics' cost at scattered lanes
    calls["K16 incl_scan (entries in lane order)"] = (
        me.incl_scan, me.incl_scan_plain, (torch.arange(n, dtype=torch.int64, device=dev), keys, n))
    calls["K16 incl_scan fill alone (m = 0)"] = (me.incl_scan, me.incl_scan_plain,
                                                 (idx[:0], keys[:0], n))
    out = {}
    for name, (fn, plain, args) in calls.items():
        compare(torch, f"{name} (probe)", fn(*args), plain(*args))
        out[name] = queued_ms(torch, lambda: fn(*args), 50)
    out["K16 scatter (the call less its fill alone)"] = \
        out["K16 incl_scan"] - out["K16 incl_scan fill alone (m = 0)"]
    return out


# K6's probe shapes (messages, blocks): the smoke's 256 five-block call,
# one and 17 blocks, and messages that fill the card (4,224: a warp on
# each of 132 SMs; 67,584: 16 warps an SM)
K6_PROBE_SHAPES = tuple((m, nb) for m in (256, 4224, 67584) for nb in (1, 5, 17))


def probe_sha(torch, dev) -> dict:
    """K5 at 1, 512 (a transition's launch) and 4,194,304 rows (phase 6's
    cold root's largest launch) and K6 at :data:`K6_PROBE_SHAPES`, each
    held against its plain version first, device ms per call queued ahead;
    and, where the checkout has it, the round-latency probe's ns per round
    with K5's and K6's chain floors in ms."""
    from consensus_specs_tpu_torch.ops import sha256
    out = {}
    for n in (1, 512, 1 << 22):
        raw = hashlib.shake_256(SEED + b"probe-k5" + n.to_bytes(4, "little")).digest(64 * n)
        rows = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(n, 64).to(dev)
        if n <= 4096:
            compare(torch, f"K5 (probe, {n} rows)", sha256.hash64(rows), sha256.hash64_plain(rows))
        out[f"K5 {n} rows"] = queued_ms(torch, lambda: sha256.hash64(rows), 20)
    for m, nb in K6_PROBE_SHAPES:
        w = k6_words(torch, sha256, m, nb, b"probe-k6")[0].to(dev)
        compare(torch, f"K6 (probe, {m} x {nb})", sha256.sha256_blocks(w, nb),
                sha256.sha256_blocks_plain(w))
        out[f"K6 {m} x {nb} blocks"] = queued_ms(torch, lambda: sha256.sha256_blocks(w, nb), 20)
    if hasattr(sha256, "sha256_chain"):
        ns = round_ns(torch, sha256, dev)
        out["round-latency probe, ns per round"] = ns
        out["K5 chain floor ms"] = sha256.hash64_chain_ops() / 4 * ns * 1e-6
        out["K6 chain floor ms at 5 blocks"] = sha256.sha256_blocks_chain_ops(5) / 4 * ns * 1e-6
    return out


def engine_sweep(torch, dev, spec, states: dict, runs: int) -> dict:
    """The columnar engine (``use_fallback``) against the mesh engine
    (``use_mesh``, floors bypassed) on the card, not leaking, at each
    registry size of ``states``: the wall ms of the sub-transitions the
    engines serve and of the post-state root (span builds on the mesh
    side from 2^14 chunks), each the least of ``runs`` runs on fresh forks
    (a fresh fork's registry columns are not on the card yet; the
    engines alternate, columnar first, then mesh first, and so on).
    Every run's root must equal the first's.  Returns {validators:
    {engine: (subs ms, root ms)}}."""
    from consensus_specs_tpu_torch.ops import epoch_kernels as ek
    from consensus_specs_tpu_torch.parallel import mesh_state
    from consensus_specs_tpu_torch.state import arrays as state_arrays
    from consensus_specs_tpu_torch.utils import ssz
    subs = EPOCH_PATHS[spec.fork]["subs"]
    out = {}
    ek.use_vectorized(dev)
    for n, pre in sorted(states.items()):
        best, first = {}, None
        for i in range(runs):
            for engine in ("columnar", "mesh")[::1 - 2 * (i % 2)]:
                (mesh_state.use_mesh if engine == "mesh" else mesh_state.use_fallback)()
                s = state_arrays.fork_state(pre)
                clock = StageClock(sync=torch.cuda.synchronize)
                for name in subs:
                    clock.wrap(spec, name)
                try:
                    spec.process_slots(s, EPOCH_SLOT + 1)
                finally:
                    clock.restore()
                    for name in subs:
                        delattr(spec, name)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                root = bytes(ssz.hash_tree_root(s))
                torch.cuda.synchronize()
                t_root = (time.perf_counter() - t0) * 1e3
                old = best.get(engine, (float("inf"), float("inf")))
                best[engine] = (min(old[0], sum(clock.ms.values())), min(old[1], t_root))
                first = first or root
                check(root == first, f"engine sweep ({spec.fork}, {n} validators, run {i}, "
                                     f"{engine}): the root differs from the first run's")
        out[n] = best
    mesh_state.use_auto()
    print(f"engine sweep ({spec.fork}, not leaking): sub-transitions ms / post-state root ms, "
          f"least of {runs} runs, columnar vs mesh: "
          + "; ".join(f"{n} validators {b['columnar'][0]:.2f} / {b['columnar'][1]:.2f} vs "
                      f"{b['mesh'][0]:.2f} / {b['mesh'][1]:.2f}" for n, b in out.items())
          + " (equal roots)")
    return out


def probe_sweep(torch, dev, runs: int) -> dict:
    """:func:`engine_sweep` on phase0 states of :data:`SWEEP_VALIDATORS`
    validators (``epoch_state``, keys cycling over :data:`SWEEP_KEYS`
    registry keys) and on their ``upgrade_to_altair`` (``altair_epoch_state``)."""
    import numpy as np
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import sha256
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as O
    from consensus_specs_tpu_torch.ops.bls12_381.fields import R_ORDER
    from consensus_specs_tpu_torch.utils import bls, ssz
    bls.use_torch()
    sha256.install_merkle_hasher(dev)
    sks = [int.from_bytes(hashlib.sha256(SEED + b"sk" + i.to_bytes(4, "little")).digest(),
                          "little") % (R_ORDER - 1) + 1 for i in range(SWEEP_KEYS)]
    pks = [O.SkToPk(sk) for sk in sks]
    p0, alt = build_spec("phase0", "mainnet"), build_spec("altair", "mainnet")
    base = {m: epoch_state(p0, ssz, np, pks, m, seed=m) for m in SWEEP_VALIDATORS}
    upgraded = {m: altair_epoch_state(alt, ssz, np, epoch_state(p0, ssz, np, pks, m, seed=m),
                                      seed=m) for m in SWEEP_VALIDATORS}
    bls.bls_active = False              # epoch processing verifies no signature
    try:
        return {"phase0": engine_sweep(torch, dev, p0, base, runs),
                "altair": engine_sweep(torch, dev, alt, upgraded, runs)}
    finally:
        bls.bls_active = True


def probe_eip7594(torch, dev) -> dict:
    """EIP-7594 at full width through the spec's entry points on the card
    (the proposer's path, too long for the smoke): one seeded mainnet
    blob through ``compute_cells_and_proofs`` (128 multiproofs, timed
    split into host polynomial work and ``g1_lincomb``), a seeded half of
    its cells through ``recover_cells_and_kzg_proofs`` (the same cells
    and proofs back), the 128 ``DataColumnSidecar``s of a one-blob block
    each through ``verify_data_column_sidecar_kzg_proofs`` outside a scope
    (one K4 launch each); then ``upgrade_to_eip7594`` of a 2^20-validator
    Deneb state (serialize and decode) and the new state's cold root."""
    import numpy as np
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.forks import build_spec
    from consensus_specs_tpu_torch.ops import kzg as K
    from consensus_specs_tpu_torch.ops import kzg_7594 as K7
    from consensus_specs_tpu_torch.ops import msm, sha256
    from consensus_specs_tpu_torch.utils import bls, ssz
    bls.use_torch(dev)
    sha256.install_merkle_hasher(dev)
    spec = build_spec("eip7594", "mainnet")
    setup, width = spec.kzg_setup, int(spec.FIELD_ELEMENTS_PER_BLOB)
    n_cells = spec.cells_per_blob()
    blob = b"".join(x.to_bytes(32, "big")
                    for x in field_elements(b"probe-7594", width, K.BLS_MODULUS))
    t0 = time.perf_counter()
    for p in setup.KZG_SETUP_G1_MONOMIAL:
        K._to_g1(p)
    out = {"monomial_decompression_s": time.perf_counter() - t0}
    commitment = spec.blob_to_kzg_commitment(blob)

    host, card = StageClock(), StageClock(sync=torch.cuda.synchronize)
    host.wrap(K, "g1_lincomb")
    for name in PROOF_HOST_STAGES:
        host.wrap(K7, name)
    for name in ("expand_windows", "msm_core"):
        card.wrap(msm, name)
    _build.reset_launches()
    t0 = time.perf_counter()
    cells, proofs = spec.compute_cells_and_proofs(blob)
    torch.cuda.synchronize()
    out["proofs_s"] = time.perf_counter() - t0
    host.restore()
    card.restore()
    out["proofs_g1_lincomb_s"] = host.ms["g1_lincomb"] / 1e3
    out["proofs_card_s"] = sum(card.ms.values()) / 1e3
    out["proofs_polynomial_s"] = sum(host.ms.get(k, 0.0) for k in PROOF_HOST_STAGES) / 1e3
    out["proofs_launches"] = {k: _build.launches[k] for k in ("expand_windows", "g1_msm")}
    check(len(proofs) == n_cells and cells == spec.compute_cells(blob),
          "eip7594 probe: compute_cells_and_proofs' cells")
    check(all(spec.verify_cell_proof(commitment, i, spec.cell_to_bytes(cells[i]), proofs[i])
              for i in (0, n_cells - 1)), "eip7594 probe: a cell proof fails verify_cell_proof")

    order = sorted(range(n_cells), key=lambda c: hashlib.sha256(SEED + b"half" + bytes([c])).digest())
    half = sorted(order[:n_cells // 2])
    t0 = time.perf_counter()
    got_cells, got_proofs = spec.recover_cells_and_kzg_proofs(
        half, [spec.cell_to_bytes(cells[i]) for i in half])
    torch.cuda.synchronize()
    out["recover_with_proofs_s"] = time.perf_counter() - t0
    check(got_cells == cells and got_proofs == proofs,
          "eip7594 probe: recovered cells or proofs differ")

    block = spec.BeaconBlock(slot=1, body=spec.BeaconBlockBody(blob_kzg_commitments=[commitment]))
    signed = spec.SignedBeaconBlock(message=block, signature=b"\xc0" + b"\x00" * 95)
    t0 = time.perf_counter()
    sidecars = spec.get_data_column_sidecars(signed, [(cells, proofs)])
    out["sidecars_build_s"] = time.perf_counter() - t0
    _build.reset_launches()
    t0 = time.perf_counter()
    check(all(spec.verify_data_column_sidecar_kzg_proofs(sc) for sc in sidecars),
          "eip7594 probe: a sidecar fails")
    torch.cuda.synchronize()
    out["sidecars_verify_s"] = time.perf_counter() - t0
    out["sidecars_k4_launches"] = _build.launches["pairing_check"]
    check(len(sidecars) == n_cells and out["sidecars_k4_launches"] == n_cells,
          f"eip7594 probe: {out['sidecars_k4_launches']} K4 launches for {len(sidecars)} sidecars")

    dspec = build_spec("deneb", "mainnet")
    n = VALIDATORS
    keys = [hashlib.sha256(SEED + b"probe key" + i.to_bytes(4, "little")).digest()[:16] * 3
            for i in range(REGISTRY)]
    t0 = time.perf_counter()
    pre = build_registry_state(dspec, ssz, np, keys, n)
    for name, width_b in (("previous_epoch_participation", 1), ("current_epoch_participation", 1),
                          ("inactivity_scores", 8)):
        setattr(pre, name, ssz.deserialize(type(getattr(pre, name)), bytes(width_b * n)))
    ssz.hash_tree_root(pre)
    torch.cuda.synchronize()
    out["deneb_state_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = pre.serialize()
    out["serialize_s"] = time.perf_counter() - t0
    del data
    t0 = time.perf_counter()
    post = spec.upgrade_to_eip7594(pre)
    out["upgrade_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssz.hash_tree_root(post)
    torch.cuda.synchronize()
    out["cold_root_s"] = time.perf_counter() - t0
    check(bytes(post.fork.current_version) == bytes(spec.config.EIP7594_FORK_VERSION)
          and len(post.validators) == n, "eip7594 probe: the upgraded state")
    return out


PROBES = {"k1": probe_k1, "k18": probe_k18, "k3": probe_k3, "k2": probe_k2, "k7": probe_k7,
          "k4": probe_k4, "k8": probe_k8, "k15": probe_k15, "k9": probe_k9, "k17": probe_k17,
          "epoch": probe_epoch, "sha": probe_sha, "eip7594": probe_eip7594}


def probe_main(torch, card: str, root: str, runs: int, only=None) -> int:
    from consensus_specs_tpu_torch import _build
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    for lib, text in sorted(_build.ptxas_report.items()):
        for line in ptxas_summary(text):
            print(f"ptxas {lib}.cu: {line}")
    result = {"root": root, "card": card, "build_s": time.perf_counter() - t0}
    for name, probe in PROBES.items():
        if only is None or name in only:
            result[name] = probe(torch, dev)
    for name in ("k1", "k3", "k2"):
        for n, v in result.get(name, {}).items():
            print(f"{name.upper()} {n} ({v['path']}): {v['queued_ms']:.4f} ms per call queued "
                  f"ahead on {card}")
    for n, v in result.get("k18", {}).items():
        print(f"K18 {n} leaves: {json.dumps(v)} (ms per call queued ahead) on {card}")
    for n, ms in result.get("k7", {}).items():
        print(f"K7 N={n}: {ms:.4f} ms per call queued ahead on {card}")
    for tag, v in result.get("k4", {}).items():
        print(f"K4 {tag}: {json.dumps(v)} on {card}")
    for tag, v in result.get("k8", {}).items():
        print(f"K8 {tag}: {json.dumps(v)} on {card}")
    for name, ms in result.get("k15", {}).items():
        print(f"K15 {name}: {ms:.5f} ms per call queued ahead on {card}")
    for tag, v in result.get("k9", {}).items():
        print(f"K9 {tag}: {json.dumps(v)} (ms per transform queued ahead) on {card}")
    for name, ms in result.get("k17", {}).items():
        print(f"K17 {name}: {ms:.5f} ms per call queued ahead on {card}")
    for name, ms in {**result.get("epoch", {}), **result.get("sha", {})}.items():
        unit = "" if "ns per" in name or "floor" in name else " ms per call queued ahead"
        print(f"{name}: {ms:.6f}{unit} on {card}")
    for name, v in result.get("eip7594", {}).items():
        print(f"eip7594 {name}: {v} on {card}")
    if runs:
        result["sweep"] = probe_sweep(torch, dev, runs)
    print(card)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--validators", type=int, default=VALIDATORS,
                    help="active validators of the phase0, Altair, Capella and Deneb states "
                         "(default 2^20)")
    ap.add_argument("--probe", action="store_true",
                    help="time the kernels through their wrappers instead of the phases")
    ap.add_argument("--root", default=None,
                    help="with --probe: a checkout of the port inside this one to measure")
    ap.add_argument("--only", default=None, metavar="K1,K18,...",
                    help="with --probe: time only these (of K1, K18, K3, K2, K7, K4, K8, K15, "
                         "K9, K17, epoch: K10-K14 and K16, sha: K5 and K6, eip7594: the "
                         "full-width cell proofs, recovery, sidecars and the 2^20 upgrade)")
    ap.add_argument("--sweep", type=int, default=0, metavar="RUNS",
                    help="with --probe: the engine sweep, the least of RUNS runs each")
    opts = ap.parse_args(argv)
    if (opts.root or opts.sweep or opts.only) and not opts.probe:
        ap.error("--root, --only and --sweep go with --probe")
    only = None if opts.only is None else {k.strip().lower() for k in opts.only.split(",")}
    if only is not None and not only <= set(PROBES):
        ap.error(f"--only: kernels of {sorted(PROBES)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    here = os.path.realpath(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.realpath(opts.root or here)
    if os.path.commonpath([root, here]) != here:
        ap.error("--root must lie inside this checkout")
    sys.path.insert(0, root)
    try:
        from consensus_specs_tpu_torch import _build
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing ({exc})", file=sys.stderr)
        return 2
    if opts.probe:
        return probe_main(torch, card_line(), os.path.relpath(root, here), opts.sweep, only)
    from consensus_specs_tpu_torch.ops import bls_torch, bls_rlc
    from consensus_specs_tpu_torch.ops.bls12_381 import ciphersuite as O
    from consensus_specs_tpu_torch.ops.bls12_381 import hash_to_curve as OH
    from consensus_specs_tpu_torch.ops.bls12_381.curve import (
        G1_GENERATOR, G2_GENERATOR, G1Point, G2Point)
    from consensus_specs_tpu_torch.ops.bls12_381.fields import R_ORDER
    from consensus_specs_tpu_torch.ops.bls12_381.pairing import multi_pairing_check
    from consensus_specs_tpu_torch.ops.torch_bls import htc, pairing, points
    from consensus_specs_tpu_torch.ops.torch_bls import convert as C
    from consensus_specs_tpu_torch.ops.torch_bls import limbs as L
    from consensus_specs_tpu_torch.utils import bls

    cu = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    marks = [time.perf_counter()] * 2

    def lap(done: str) -> None:
        """Wall seconds of the phase just done, and of the run so far."""
        now = time.perf_counter()
        print(f"elapsed: {done} {now - marks[1]:.1f} s (run {now - marks[0]:.1f} s)")
        marks[1] = now

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    for lib in _build.LIBS:
        _build.load(lib)
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"(nvcc {_build.build_seconds or 0.0:.1f} s, sources built in parallel)")
    for lib, text in sorted(_build.ptxas_report.items()):
        for line in ptxas_summary(text):
            print(f"ptxas {lib}.cu: {line}")

    lap("phase 1")

    # ---- 2. each kernel against its plain version and the oracle -------
    def h(*parts) -> int:
        return int.from_bytes(hashlib.sha256(SEED + b"".join(parts)).digest(), "little")

    scal = lambda ss: bls_torch._scalar_words(ss, torch.device("cpu"))
    keys = [G1_GENERATOR.mult(h(b"k", bytes([i])) % R_ORDER) for i in range(6)]
    rows = [[keys[0], keys[1], keys[1], keys[2]], [keys[3], -keys[3]], [keys[4]],
            [keys[5], keys[0], keys[1], keys[2], keys[3], keys[4], keys[5], keys[0]]]
    pk = torch.zeros((4, 8, 2, 12), dtype=torch.int32)
    for i, r in enumerate(rows):
        pk[i, :len(r)] = C.pack_g1(r)[0]
    cnt = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    ss = [h(b"s", bytes([i])) % (1 << 128) for i in range(4)]
    sc = scal(ss)
    for with_sc in (True, False):
        s_arg = sc.to(cu) if with_sc else None
        ka, ki = points.g1_aggregate_scale(pk.to(cu), cnt, s_arg)
        compare(torch, "K1", (ka, ki), points.g1_aggregate_scale_plain(pk.to(cu), cnt, s_arg))
        want = []
        for r, s in zip(rows, ss):
            acc = G1Point.inf()
            for p in r:
                acc = acc + p
            want.append((acc.mult(s) if with_sc else acc).to_compressed())
        check([p.to_compressed() for p in C.unpack_g1(ka, ki)] == want,
              "K1 differs from the oracle")
    check(bool(ki[1]), "K1: pk + (-pk) must aggregate to the identity")

    sigs = [G2_GENERATOR.mult(h(b"g", bytes([i])) % R_ORDER) for i in range(3)] + [G2Point.inf()]
    sw, si = (t.to(cu) for t in C.pack_g2(sigs))
    ka, ki = points.g2_scale_sum(sw, si, sc.to(cu))
    compare(torch, "K2", (ka, ki), points.g2_scale_sum_plain(sw, si, sc.to(cu)))
    acc = G2Point.inf()
    for p, s in zip(sigs, ss):
        acc = acc + p.mult(s)
    check(C.unpack_g2(ka, ki)[0] == acc, "K2 differs from the oracle")

    msgs = [b"", b"abc", b"chip-smoke", bytes(range(64))]
    u = htc.hash_to_field_host(msgs).to(cu)
    ka, ki = htc.hash_to_g2(u)
    compare(torch, "K3", (ka, ki), htc.hash_to_g2_plain(u))
    check(C.unpack_g2(ka, ki) == [OH.hash_to_g2(m) for m in msgs], "K3 differs from the oracle")

    a = h(b"a") % R_ORDER
    Pp = [G1_GENERATOR.mult(a), -G1_GENERATOR, G1_GENERATOR, G1_GENERATOR]
    Qp = [G2_GENERATOR, G2_GENERATOR.mult(a), G2_GENERATOR.mult(a + 1), G2_GENERATOR]
    dg = torch.tensor([False, False, False, True])
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    args = (C.pack_g1(Pp)[0].to(cu), C.pack_g2(Qp)[0].to(cu), dg.to(cu), off)
    ko = pairing.pairing_check(*args)
    compare(torch, "K4", ko, pairing.pairing_check_plain(*args))
    compare(torch, "K4 GT values", pairing.pairing_check_gt(*args),
            pairing.pairing_check_gt_plain(*args))
    want = [multi_pairing_check(list(zip(Pp[:2], Qp[:2]))), multi_pairing_check([(Pp[2], Qp[2])])]
    check(ko.cpu().tolist() == want == [True, False], f"K4 differs from the oracle: {ko.tolist()}")
    print("kernel checks (small inputs): K1-K4 byte-identical to their plain versions "
          "on the card (K4's GT values too) and to the python oracle (tolerance 0: integer "
          "outputs)")

    lap("phase 2")

    # ---- 3. a mainnet-shaped block ---------------------------------------
    t0 = time.perf_counter()
    sks = [h(b"sk", i.to_bytes(4, "little")) % (R_ORDER - 1) + 1 for i in range(REGISTRY)]
    pks = [O.SkToPk(sk) for sk in sks]
    for pk_b in pks:                        # KeyValidate once per registry key
        check(bls_torch._packed_g1(pk_b) is not None, "registry key failed KeyValidate")
    t_reg = time.perf_counter() - t0

    def committee(c):
        return [(c * COMMITTEE + j) % REGISTRY for j in range(COMMITTEE)]

    def agg_sign(idx, msg):
        return O.Sign(sum(sks[i] for i in idx) % R_ORDER, msg)

    t0 = time.perf_counter()
    items = []
    for c in range(ATTESTATIONS):
        idx = committee(c)
        msg = hashlib.sha256(SEED + b"att" + c.to_bytes(4, "little")).digest()
        items.append(([pks[i] for i in idx], msg, agg_sign(idx, msg)))
    sync_idx = list(range(SYNC))
    sync_msg = hashlib.sha256(SEED + b"sync").digest()
    items.append(([pks[i] for i in sync_idx], sync_msg, agg_sign(sync_idx, sync_msg)))
    for tag, who in ((b"proposer", 7), (b"randao", 7)):
        msg = hashlib.sha256(SEED + tag).digest()
        items.append(([pks[who]], msg, agg_sign([who], msg)))
    for _, _, sig in items:                 # decompress + subgroup check once
        check(bls_torch._decompress_g2(sig) is not None, "signature failed decompression")
    t_sign = time.perf_counter() - t0
    n_keys = sum(len(it[0]) for it in items)
    print(f"block: {len(items)} items, {n_keys} pubkeys; reduced: registry "
          f"{REGISTRY} keys (mainnet 1048576); set-up: registry {t_reg:.1f} s, "
          f"signatures {t_sign:.1f} s (host)")

    # every kernel call of the flush and of the per-lane batch keeps its
    # arguments, so phase 4 holds each kernel against its plain version
    # at exactly the shapes the block gave it
    bls.use_torch()
    recorded, path = {}, [None]

    def recorder(name, fn):
        def wrapped(*a):
            recorded[(path[0], name)] = a
            return fn(*a)
        return wrapped

    originals = {n: getattr(bls_torch, n) for n in KERNELS}
    for n, fn in originals.items():
        setattr(bls_torch, n, recorder(n, fn))

    batch = bls.DeferredBatch()
    for it in items:
        batch.add(*it)
    path[0] = "flush"
    _build.reset_launches()
    t0 = time.perf_counter()
    ok = batch.flush()
    torch.cuda.synchronize()
    flush_first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launches)
    check(ok is True, "the block's RLC flush must pass")
    check(batch.pairings == 1, f"expected one product pairing, got {batch.pairings}")
    check(batch.last_results == [True] * len(items), "last_results must be all True")
    check(all(launches[k] > 0 for k in KERNELS), f"a kernel was not launched: {launches}")
    print(f"flush: True with {batch.pairings} product pairing; launches {launches}")

    path[0] = "lanes"
    _build.reset_launches()
    lanes = bls_torch.verify_aggregates_batch(items)
    lane_launches = dict(_build.launches)
    for n, fn in originals.items():
        setattr(bls_torch, n, fn)
    check(lanes == [True] * len(items), "per-lane batch verify must pass every item")
    print(f"verify_aggregates_batch: {len(items)} x True; launches {lane_launches}")

    bad = 37
    other = hashlib.sha256(SEED + b"other message").digest()
    forged = list(items)
    forged[bad] = (items[bad][0], items[bad][1], agg_sign(committee(bad), other))
    batch = bls.DeferredBatch()
    for it in forged:
        batch.add(*it)
    ok = batch.flush()
    failed = [i for i, r in enumerate(batch.last_results) if not r]
    check(ok is False and failed == [bad], f"bad signature not isolated: {failed}")
    check(batch.pairings == 1 + len(items), "bisect must follow the failed product")
    print(f"forged flush: False; last_results names item {failed}")

    av_keys = list(range(16))
    av_msgs = [hashlib.sha256(SEED + b"av" + bytes([i])).digest() for i in av_keys]
    av_sig = O.Aggregate([O.Sign(sks[i], m) for i, m in zip(av_keys, av_msgs)])
    av_pks = [pks[i] for i in av_keys]
    check(bls.AggregateVerify(av_pks, av_msgs, av_sig) is True, "AggregateVerify must pass")
    av_bad = list(av_msgs)
    av_bad[5] = other
    check(bls.AggregateVerify(av_pks, av_bad, av_sig) is False, "AggregateVerify must fail")
    print("AggregateVerify: 16 messages True; one message changed False")

    lap("phase 3")

    # ---- 4. each kernel at the block's shapes; timings ---------------------
    plain = {"g1_aggregate_scale": points.g1_aggregate_scale_plain,
             "g2_scale_sum": points.g2_scale_sum_plain,
             "hash_to_g2": htc.hash_to_g2_plain,
             "pairing_check": pairing.pairing_check_gt_plain}
    products = {"g1_aggregate_scale": points.g1_aggregate_scale_fq_products,
                "g2_scale_sum": points.g2_scale_sum_fq_products,
                "hash_to_g2": htc.hash_to_g2_fq_products,
                "pairing_check": pairing.pairing_check_fq_products}
    meta = {
        "g1_aggregate_scale": ("consensus_specs_tpu_torch/csrc/points.cu",
                               "consensus_specs_tpu/ops/bls_jax.py:196"),
        "g2_scale_sum": ("consensus_specs_tpu_torch/csrc/points.cu",
                         "consensus_specs_tpu/ops/bls_jax.py:498"),
        "hash_to_g2": ("consensus_specs_tpu_torch/csrc/htc.cu",
                       "consensus_specs_tpu/ops/jax_bls/htc.py:150"),
        "pairing_check": ("consensus_specs_tpu_torch/csrc/pairing.cu",
                          "consensus_specs_tpu/ops/jax_bls/pairing.py:452"),
    }
    edge_err = {"g1_aggregate_scale": k1_edges(torch, cu)}
    edge_err["g2_scale_sum"] = edge_err["hash_to_g2"] = k2_k3_edges(torch, cu)
    chain = {"g1_aggregate_scale": lambda pk, counts, sc=None:
             points.g1_aggregate_scale_chain(counts, sc),
             "g2_scale_sum": lambda sig, sig_inf, sc: points.g2_scale_sum_chain(sig_inf, sc),
             "hash_to_g2": lambda u: htc.hash_to_g2_chain()}
    kernels = []
    for name in KERNELS:
        fn = originals[name]
        err, p_ms = edge_err.get(name, 0), None
        for which in ("flush", "lanes"):
            if (which, name) not in recorded:
                continue
            args = recorded[(which, name)]
            got = fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain[name](*args)
            torch.cuda.synchronize()
            if which == "flush":
                p_ms = (time.perf_counter() - t0) * 1e3
            if name == "pairing_check":
                compare(torch, f"K4 GT values ({which}, block shapes)",
                        pairing.pairing_check_gt(*args), want)
                want = want[0]
            err = max(err, compare(torch, f"{name} ({which}, block shapes)", got, want))
            shapes = [tuple(t.shape) for t in args if isinstance(t, torch.Tensor)]
            print(f"check {name} ({which}): equal to its plain version at shapes {shapes}")
        args = recorded[("flush", name)]
        k_ms = cuda_ms(torch, lambda: fn(*args))
        fq = products[name](*args)
        b_ms = fq * L.IMAD_PER_FQ_MUL / IMAD_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": "operations",
            "library_ms": None, "fq_products": fq})
        if name in chain:
            kernels[-1]["chain_fq_products"] = chain[name](*args)
        if name == "g1_aggregate_scale":        # the per-lane batch's call: no scalars
            lane_args = recorded[("lanes", name)]
            kernels[-1].update(lanes_ms=cuda_ms(torch, lambda: fn(*lane_args)),
                               lanes_chain_fq_products=chain[name](*lane_args),
                               lanes_shapes=[tuple(t.shape) for t in lane_args])
        print(f"time {name}: {k_ms:.3f} ms (plain {p_ms:.1f} ms, bound {b_ms:.5f} ms "
              f"from {fq} Fq products"
              + (f"; chain floor {kernels[-1]['chain_fq_products']} dependent Fq products"
                 if name in chain else "") + f") on {card}")
    k4_tampered(torch, pairing, recorded[("flush", "pairing_check")], "the block flush")

    def flush_once():
        b = bls.DeferredBatch()
        for it in items:
            b.add(*it)
        b.flush()

    flush_ms = cuda_ms(torch, flush_once)
    lanes_ms = cuda_ms(torch, lambda: bls_torch.verify_aggregates_batch(items[:ATTESTATIONS]))

    # where a flush's time goes: host stages (wall clock) and device busy
    # time (profiler), one more flush each
    clock = StageClock()
    clock.wrap(bls_rlc, "derive_scalars")
    for name in ("_stack_pk_rows", "_pack_g2", "hash_to_field_host", "_scalar_words") + KERNELS:
        clock.wrap(bls_torch, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush_once()
    torch.cuda.synchronize()
    staged_wall = (time.perf_counter() - t0) * 1e3
    clock.restore()
    stages = ", ".join(f"{k} {v:.2f}" for k, v in sorted(clock.ms.items(), key=lambda kv: -kv[1]))
    print(f"flush host stages (ms, wall clock, wrapper calls include their launch "
          f"and any wait): total {staged_wall:.2f}; {stages}; rest "
          f"{staged_wall - sum(clock.ms.values()):.2f} on {card}")
    prof_wall, dev = profile_once(torch, flush_once)
    busy = sum(dev.values())
    top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8])
    if busy:
        print(f"flush profile: wall {prof_wall:.2f} ms, device busy {busy:.2f} ms, idle share "
              f"{1 - busy / prof_wall:.3f}; device ms by event: {top} on {card}")
    else:
        print(f"flush profile: wall {prof_wall:.2f} ms; the profiler reported no device "
              f"time (idle share not measured) on {card}")
    print(f"time block flush (RLC, 131 items, host work included): {flush_ms:.2f} ms "
          f"(first, cold caches: {flush_first_ms:.1f} ms) on {card}")
    print(f"time per-lane batch (128 attestations): {lanes_ms:.2f} ms on {card}")

    lap("phase 4")

    # ---- 5. the SHA-256 kernels against their plain versions and hashlib ---
    from consensus_specs_tpu_torch.ops import sha256
    sha_checked = sha_kernel_checks(torch, cu, sha256)

    lap("phase 5")

    # ---- 15. K15-K18 against their plain versions (and K18 against hashlib)
    mesh_err = dict.fromkeys(MESH_KERNELS, mesh_kernel_checks(torch, cu, opts.validators))
    mesh_err["merkle_levels"] = merkle_checks(torch, cu, opts.validators)

    lap("phase 15")

    # ---- 7. K7, K8 and K9 against their plain versions and the oracle --------
    err = slice3_kernel_checks(torch, cu)

    lap("phase 7")

    # ---- 8. a block's blobs through the KZG library ----------------------------
    from consensus_specs_tpu_torch.ops import kzg
    setup = kzg.trusted_setup("mainnet")
    blob = blob_phase(torch, cu, card, setup)

    lap("phase 8")

    # ---- 9. PeerDAS recovery and sampling ---------------------------------------
    das = peerdas_phase(torch, cu, card, setup, blob["blobs"], blob["cs"])
    for k in err:
        err[k] = max(err[k], blob["err"].get(k, 0), das["err"].get(k, 0))
    s3_launches = {k: blob["launches"][k] + das["launches"][k] for k in blob["launches"]}

    lap("phase 9")

    # ---- 6. a mainnet phase0 block through state_transition -----------------
    k5, block_launches, phase0_state, cold_k18, bls_err = phase0_block(
        torch, cu, card, sks, pks, opts.validators)
    mesh_err["merkle_levels"] = max(mesh_err["merkle_levels"], cold_k18["err"])
    for e in kernels:
        if e["name"] in bls_err:
            e["phase0_block_launches"] = block_launches[e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], bls_err[e["name"]])
    kernels.append(with_chain_floor(k5, sha256.hash64_chain_ops(), sha_checked["round_ns"]))
    print(f"hash64 chain floor: {k5['chain_ops']} dependent instructions -> "
          f"{k5['chain_ms']:.6f} ms at {k5['round_ns']:.4f} ns a round; bound "
          f"{k5['bound_ms']:.6f} ms by {k5['bound_term']} at {k5['rows']} rows on {card}")
    kernels.append(sha256_blocks_entry(torch, card, sha256, sha_checked["sha256_blocks"],
                                       block_launches["sha256_blocks"], sha_checked["round_ns"]))

    lap("phase 6")

    # ---- 13. a mainnet Altair block through state_transition (run here, on
    # phase 6's state, so that no 2^20-validator state outlives its use:
    # every full garbage collection of the later phases scans what is alive)
    held = {(name, str([tuple(t.shape) for t in args if isinstance(t, torch.Tensor)]))
            for (_, name), args in recorded.items()}
    ablock = altair_block_phase(torch, cu, card, sks, pks, phase0_state, held)
    del phase0_state
    for e in kernels:
        if e["name"] in ablock["launches"]:
            e["altair_block_launches"] = ablock["launches"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], ablock["err"][e["name"]])
    mesh_err["merkle_levels"] = max(mesh_err["merkle_levels"], ablock["k18_err"])

    lap("phase 13")

    # ---- 17. a mainnet Capella block through state_transition (phase 13's
    # pre-state taken on through the two upgrades) ---------------------------
    cblock = capella_block_phase(torch, cu, card, sks, pks, ablock.pop("state"), held)
    for e in kernels:
        if e["name"] in cblock["launches"]:
            e["capella_block_launches"] = cblock["launches"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], cblock["err"][e["name"]])
        if e["name"] in cblock["shapes"]:
            e["capella_block_shapes"] = cblock["shapes"][e["name"]]["shapes"]
            e["capella_block_ms"] = cblock["shapes"][e["name"]]["ms"]
    mesh_err["merkle_levels"] = max(mesh_err["merkle_levels"], cblock["k18_err"])

    lap("phase 17")

    # ---- 19. a mainnet Deneb block with six blobs (phase 17's pre-state taken
    # on through upgrade_to_deneb, phase 8's blobs) -----------------------------
    dblock = deneb_block_phase(torch, cu, card, sks, pks, cblock.pop("state"), blob,
                               held | cblock["held"] | blob["held"],
                               after_cold=lambda st: eip7594_upgrade(torch, card, st))
    for e in kernels:
        if e["name"] in dblock["launches"]:
            e["deneb_block_launches"] = dblock["launches"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], dblock["err"][e["name"]])
        if e["name"] in dblock["shapes"]:
            e["deneb_block_shapes"] = dblock["shapes"][e["name"]]
    mesh_err["merkle_levels"] = max(mesh_err["merkle_levels"], dblock["k18_err"])

    lap("phase 19")

    # ---- 21. a mainnet EIP-7594 block whose six blobs are sampled by cell
    # (phase 19's Deneb state upgraded after its cold root, phase 9's cells) ----
    k4_held = {("pairing_check", str([tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]))
               for a in (blob["k4_call"], das["k4_call"])}
    eblock = eip7594_block_phase(torch, cu, card, sks, pks, dblock.pop("forked"), dblock, blob,
                                 das, held | cblock["held"] | blob["held"] | das["held"]
                                 | dblock["held"] | k4_held)
    for e in kernels:
        if e["name"] in eblock["launches"]:
            e["eip7594_block_launches"] = eblock["launches"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], eblock["err"][e["name"]])
        if e["name"] in eblock["shapes"]:
            e["eip7594_block_shapes"] = eblock["shapes"][e["name"]]
        if e["name"] in eblock["votes"]["att_launches"]:
            # fork choice after on_block: 128 on_attestations with the verify
            # memo kept (no launch), 128 with it cleared, and a slashing
            e["eip7594_on_attestation_memo_kept_launches"] = \
                eblock["votes"]["kept_launches"][e["name"]]
            e["eip7594_on_attestation_memo_cleared_launches"] = \
                eblock["votes"]["att_launches"][e["name"]]
            e["eip7594_attester_slashing_launches"] = \
                eblock["votes"]["slash_launches"][e["name"]]
            e["eip7594_fork_choice_shapes"] = eblock["votes"]["shapes"][e["name"]]
            e["eip7594_fork_choice_shape_ms"] = eblock["votes"]["shape_ms"][e["name"]]
    mesh_err["merkle_levels"] = max(mesh_err["merkle_levels"], eblock["k18_err"])

    lap("phase 21")

    # ---- K4 at every path's shape; K7-K9 per launch ------------------------------
    k4 = next(e for e in kernels if e["name"] == "pairing_check")
    k4["max_abs_err"] = max(k4["max_abs_err"], blob["err"]["pairing_check"],
                            das["err"]["pairing_check"])
    k4["slice3_launches"] = s3_launches["pairing_check"]
    k4["shapes"] = k4_shapes(torch, card, pairing, {
        "block flush": (recorded[("flush", "pairing_check")], launches["pairing_check"]),
        "per-lane batch": (recorded[("lanes", "pairing_check")],
                           lane_launches["pairing_check"]),
        "blob batch verify": (blob["k4_call"], blob["k4_launches"]),
        "cell batch verify": (das["k4_call"], das["k4_launches"]),
        "capella block flush": (cblock["k4_call"], cblock["launches"]["pairing_check"]),
        "deneb block flush": (dblock["k4_call"], dblock["launches"]["pairing_check"]),
        "eip7594 block flush": (eblock["k4_call"], eblock["launches"]["pairing_check"])})
    k4["deneb_block_ms"] = dblock["k4_ms"]
    k4["eip7594_block_ms"] = eblock["k4_ms"]
    k4["eip7594_sidecar_launches"] = eblock["sidecar_launches"]["pairing_check"]
    k4["eip7594_changed_cell_launches"] = eblock["altered_k4_launches"]
    k4["eip7594_withheld_launches"] = eblock["withheld_launches"]["pairing_check"]
    kernels += slice3_entries(torch, card, blob, das, err, s3_launches)
    for e in kernels:
        if e["name"] in ("expand_windows", "g1_msm"):
            rec = "expand_windows" if e["name"] == "expand_windows" else "msm_core"
            e["deneb_block_launches"] = dblock["launches"][e["name"]]
            e["deneb_block_shapes"] = dblock["shapes"][rec]
            e["max_abs_err"] = max(e["max_abs_err"], dblock["err"][rec])
            e["eip7594_block_launches"] = eblock["launches"][e["name"]]
            e["eip7594_block_shapes"] = eblock["shapes"][e["name"]]
            e["eip7594_block_shape_ms"] = eblock["shape_ms"][e["name"]]
            e["eip7594_sidecar_launches"] = eblock["sidecar_launches"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], eblock["err"][e["name"]])
        if e["name"] == "fr_fft":
            e["eip7594_recover_launches"] = eblock["k9_launches"]
            e["eip7594_recover_shapes"] = eblock["k9_shapes"]
            e["max_abs_err"] = max(e["max_abs_err"], eblock["err"]["fr_fft"])

    lap("K4 shapes, K7-K9 timed")

    # ---- 10. a mainnet phase0 epoch transition ----------------------------------
    epoch = epoch_phase(torch, cu, card, pks, opts.validators)

    lap("phase 10")

    # ---- 11. K10-K12 per launch ------------------------------------------------
    kernels += epoch_entries(torch, card, epoch)

    lap("phase 11")

    # ---- 12. K13 and K14 against their plain versions ---------------------------
    altair_err = altair_kernel_checks(torch, cu, opts.validators)

    lap("phase 12")

    # ---- 14. a mainnet Altair epoch transition -----------------------------------
    aepoch = altair_epoch_phase(torch, cu, card, pks, epoch.pop("base"), epoch.pop("quiet"),
                                altair_err)
    for e in kernels:
        if e["name"] in ("effective_balance", "slashings"):
            e["altair_epoch_launches"] = max(r["launches"][e["name"]]
                                             for r in aepoch["runs"].values())
            e["max_abs_err"] = max([e["max_abs_err"]] + [r["err"][e["name"]]
                                                         for r in aepoch["runs"].values()])
    kernels += epoch_entries(torch, card, aepoch, ALTAIR_EPOCH_KERNELS)

    lap("phase 14")

    # ---- 18. a mainnet Capella epoch transition (phase 14's not-leaking
    # registry of 2^18 taken on through the two upgrades: a depth cut) ----------
    small = aepoch.pop("small")
    cepoch = capella_epoch_phase(torch, cu, card, pks, aepoch.pop("quiet"), small, altair_err)

    lap("phase 18")

    # ---- 20. a mainnet Deneb epoch transition (phase 14's 2^20 base taken on
    # through the three upgrades, 32 deposits queued for activation) ------------
    depoch = deneb_epoch_phase(torch, cu, card, pks, aepoch.pop("base"), small, altair_err)
    del small
    for tag, phase in (("capella", cepoch), ("deneb", depoch)):
        run = phase["runs"]["leaking"]
        for e in kernels:
            if e["name"] in EPOCH_PATHS[tag]["kernels"]:
                e[f"{tag}_epoch_launches"] = run["launches"][e["name"]]
                e["max_abs_err"] = max(e["max_abs_err"], run["err"][e["name"]])
            if e["name"] in phase["ms"]:
                e[f"{tag}_epoch_ms"] = phase["ms"][e["name"]]

    lap("phase 20")

    # ---- K15-K18 per launch, with their launches on every path ---------------
    paths = {"phase0_block_cold_root": {"merkle_levels": cold_k18["launches"]},
             "altair_upgrade_and_cold_root": {"merkle_levels": ablock["k18_launches"]},
             "capella_upgrades_and_cold_root": {"merkle_levels": cblock["k18_launches"]},
             "deneb_upgrade_and_cold_root": {"merkle_levels": dblock["k18_launches"]},
             "eip7594_upgrade_and_cold_root": {"merkle_levels": eblock["k18_launches"]}}
    for tag, phase in (("phase0_epoch", epoch), ("altair_epoch", aepoch),
                       ("capella_epoch", cepoch), ("deneb_epoch", depoch)):
        paths[tag] = {k: max(r["launches"][k] for r in phase["runs"].values())
                      for k in MESH_KERNELS + ("merkle_levels",)}
        for k in mesh_err:
            mesh_err[k] = max([mesh_err[k]] + [r["err"][k] for r in phase["runs"].values()])
    launches = {k: {p: v[k] for p, v in paths.items() if k in v}
                for k in MESH_KERNELS + ("merkle_levels",)}
    kernels += mesh_entries(torch, card, epoch["runs"]["leaking"], cold_k18["calls"], launches,
                            mesh_err)

    lap("phase 16 (K15-K18 timed)")

    # ---- the hashlib recomputes of phases 6, 10, 13, 14, 17, 18, 19, 20 and 21 --
    hashlib_roots.finish()

    lap("hashlib roots (waited for)")

    # ---- 16. result lines ----------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        hashlib_roots.close()
