"""EIP-7594 (PeerDAS) feature fork: data-availability sampling by cell.

Counterpart of ``consensus_specs_tpu/forks/eip7594.py``.  Behavioral
sources: ``specs/_features/eip7594/fork.md`` (the fork-version ladder,
``upgrade_to_eip7594``),
``specs/_features/eip7594/polynomial-commitments-sampling.md`` (cell
cosets, KZG multiproofs, erasure recovery) and
``specs/_features/das/das-core.md`` (custody columns,
``DataColumnSidecar`` construction and verification, the sampling
``is_data_available``).  Fork inheritance is class inheritance over
:class:`DenebSpec`.

The state layout is Deneb's: the upgrade only rotates ``state.fork``.
The field, domain and polynomial helpers delegate to
:mod:`..ops.kzg` and :mod:`..ops.kzg_7594` where those give the same
result, reading the width from the preset (``FIELD_ELEMENTS_PER_BLOB``)
as the JAX methods do; every G1 MSM goes through ``kzg.g1_lincomb`` (K7
and K8 under the torch backend), ``g2_lincomb`` stays on the oracle.

The batched DAS kernels are the route, as the JAX package's
``das/engine.py`` makes them at its default:
``verify_cell_proof_batch`` is :func:`..das.kernels.verify_cell_proof_batch`
(one product pairing a batch; inside a block's batch scope its two pairs
are deferred into the block's one product pairing under the label
``das_cells``), ``recover_polynomial`` is
:func:`..das.kernels.recover_cells_batch` (K9 on the card).  The spec
loop stays reachable as ``verify_cell_proof_batch_loop``; no path of the
runtime calls it.  The JAX engine's fault sites, breaker, audits and its
``CS_TPU_DAS`` switch are not carried.  Fork choice's ``on_block``
reaches the sampling ``is_data_available`` through Deneb's
``_on_block_data_availability_check``: each blob's cell batch joins the
block's one product pairing.
"""
from ..utils.hash_function import hash
from ..utils.ssz import hash_tree_root, uint64, ByteVector, List, Container
from ..ops import kzg as _kzg
from ..ops import kzg_7594 as _kzg7594
from ..das import kernels as _das
from . import register_fork
from .deneb import DenebSpec
from .base_types import KZGCommitment, KZGProof, Root

ColumnIndex = uint64


@register_fork("eip7594")
class EIP7594Spec(DenebSpec):
    fork = "eip7594"
    previous_fork = "deneb"

    # polynomial-commitments-sampling.md constants
    FIELD_ELEMENTS_PER_CELL = uint64(64)
    RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = _kzg7594.RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN
    PRIMITIVE_ROOT_OF_UNITY = _kzg.PRIMITIVE_ROOT_OF_UNITY
    # das-core.md constants
    DATA_COLUMN_SIDECAR_SUBNET_COUNT = uint64(32)
    CUSTODY_REQUIREMENT = uint64(1)
    SAMPLES_PER_SLOT = uint64(8)

    # -- type construction (das-core.md) -----------------------------------------

    def _build_types(self):
        super()._build_types()
        S = self
        self.NUMBER_OF_COLUMNS = uint64(self.cells_per_blob())
        self.BYTES_PER_CELL = 32 * int(self.FIELD_ELEMENTS_PER_CELL)
        self.Cell = ByteVector[self.BYTES_PER_CELL]
        self.ColumnIndex = ColumnIndex

        class DataColumnSidecar(Container):
            index: ColumnIndex
            column: List[S.Cell, S.MAX_BLOB_COMMITMENTS_PER_BLOCK]
            kzg_commitments: List[KZGCommitment, S.MAX_BLOB_COMMITMENTS_PER_BLOCK]
            kzg_proofs: List[KZGProof, S.MAX_BLOB_COMMITMENTS_PER_BLOCK]
            signed_block_header: S.SignedBeaconBlockHeader

        class DataColumnIdentifier(Container):
            block_root: Root
            index: ColumnIndex

        self.DataColumnSidecar = DataColumnSidecar
        self.DataColumnIdentifier = DataColumnIdentifier

    # -- field and domain helpers (polynomial-commitments-sampling.md) ------------

    def _width(self) -> int:
        return int(self.FIELD_ELEMENTS_PER_BLOB)

    def cells_per_blob(self) -> int:
        """Cells in one 2x-extended blob."""
        return 2 * self._width() // int(self.FIELD_ELEMENTS_PER_CELL)

    def reverse_bits(self, n, order) -> int:
        return _kzg.reverse_bits(int(n), int(order))

    def bit_reversal_permutation(self, sequence):
        return _kzg.bit_reversal_permutation(sequence)

    def compute_roots_of_unity(self, order):
        return list(_kzg.compute_roots_of_unity(int(order)))

    def bls_modular_inverse(self, x) -> int:
        return _kzg.bls_modular_inverse(int(x))

    def blob_to_polynomial(self, blob):
        return _kzg.blob_to_polynomial(bytes(blob), self._width())

    def bytes_to_cell(self, cell_bytes):
        return _kzg7594.bytes_to_cell(bytes(cell_bytes))

    def cell_to_bytes(self, cell) -> bytes:
        return b"".join(int(x).to_bytes(32, "big") for x in cell)

    def bytes_to_kzg_commitment(self, b) -> bytes:
        return _kzg.bytes_to_kzg_commitment(bytes(b))

    def bytes_to_kzg_proof(self, b) -> bytes:
        return _kzg.bytes_to_kzg_proof(bytes(b))

    def fft_field(self, vals, roots_of_unity, inv=False):
        return _kzg7594.fft_field(vals, roots_of_unity, inv=inv)

    # -- coefficient-form polynomial ring ------------------------------------------

    def polynomial_eval_to_coeff(self, polynomial):
        """Evaluation form (brp domain) -> coefficient form."""
        return self.fft_field(self.bit_reversal_permutation(list(polynomial)),
                              self.compute_roots_of_unity(self._width()), inv=True)

    def add_polynomialcoeff(self, a, b):
        return _kzg7594.add_polynomialcoeff(a, b)

    def neg_polynomialcoeff(self, a):
        return _kzg7594.neg_polynomialcoeff(a)

    def multiply_polynomialcoeff(self, a, b):
        return _kzg7594.multiply_polynomialcoeff(a, b)

    def divide_polynomialcoeff(self, a, b):
        return _kzg7594.divide_polynomialcoeff(a, b)

    def shift_polynomialcoeff(self, polynomial_coeff, factor):
        return _kzg7594.shift_polynomialcoeff(polynomial_coeff, factor)

    def interpolate_polynomialcoeff(self, xs, ys):
        return _kzg7594.interpolate_polynomialcoeff(xs, ys)

    def vanishing_polynomialcoeff(self, xs):
        return _kzg7594.vanishing_polynomialcoeff(xs)

    def evaluate_polynomialcoeff(self, polynomial_coeff, z) -> int:
        return _kzg7594.evaluate_polynomialcoeff(polynomial_coeff, z)

    # -- cells and proofs (polynomial-commitments-sampling.md) ---------------------

    def coset_for_cell(self, cell_id):
        """The cell's reverse-bit-ordered coset of the 2N-th roots."""
        assert int(cell_id) < self.cells_per_blob()
        fe_per_cell = int(self.FIELD_ELEMENTS_PER_CELL)
        roots_brp = _kzg._roots_of_unity_brp(2 * self._width())
        return list(roots_brp[fe_per_cell * int(cell_id):fe_per_cell * (int(cell_id) + 1)])

    def compute_cells(self, blob):
        """Extended evaluations of the blob polynomial, cell by cell."""
        width = self._width()
        fe_per_cell = int(self.FIELD_ELEMENTS_PER_CELL)
        polynomial_coeff = self.polynomial_eval_to_coeff(self.blob_to_polynomial(blob))
        extended_data = self.fft_field(polynomial_coeff + [0] * width,
                                       self.compute_roots_of_unity(2 * width))
        extended_data_rbo = self.bit_reversal_permutation(extended_data)
        return [extended_data_rbo[i * fe_per_cell:(i + 1) * fe_per_cell]
                for i in range(self.cells_per_blob())]

    def compute_kzg_proof_multi_impl(self, polynomial_coeff, zs):
        """Multi-point proof [q(tau)]_1 with q = (p - I) / Z, and the ys."""
        return _kzg7594.compute_kzg_proof_multi_impl(polynomial_coeff, zs, self.kzg_setup)

    def compute_cells_and_proofs(self, blob):
        """All cells with one KZG multiproof per cell."""
        polynomial_coeff = self.polynomial_eval_to_coeff(self.blob_to_polynomial(blob))
        cells, proofs = [], []
        for i in range(self.cells_per_blob()):
            proof, ys = self.compute_kzg_proof_multi_impl(polynomial_coeff,
                                                          self.coset_for_cell(i))
            cells.append(ys)
            proofs.append(proof)
        return cells, proofs

    def verify_kzg_proof_multi_impl(self, commitment, zs, ys, proof) -> bool:
        """e(proof, [Z(tau)]_2) == e(C - [I(tau)]_1, [1]_2), evaluated at
        once (one K4 group under the torch backend)."""
        return _kzg7594.verify_kzg_proof_multi_impl(commitment, zs, ys, proof, self.kzg_setup)

    def verify_cell_proof(self, commitment, cell_id, cell, proof) -> bool:
        """One cell against its row commitment (one pairing check)."""
        return self.verify_kzg_proof_multi_impl(
            self.bytes_to_kzg_commitment(commitment), self.coset_for_cell(cell_id),
            self.bytes_to_cell(cell), self.bytes_to_kzg_proof(proof))

    def verify_cell_proof_batch(self, row_commitments, row_ids, column_ids, cells,
                                proofs) -> bool:
        """The whole batch in one product pairing check, deferred into a
        block's batch scope (``das/kernels.py``); the JAX package's engine
        route, with its verdicts."""
        return _das.verify_cell_proof_batch(
            [bytes(c) for c in row_commitments], [int(r) for r in row_ids],
            [int(c) for c in column_ids], [bytes(c) for c in cells], [bytes(p) for p in proofs],
            self.kzg_setup)

    def verify_cell_proof_batch_loop(self, row_commitments, row_ids, column_ids, cells,
                                     proofs) -> bool:
        """The spec loop: one multiproof check, and one pairing, per cell."""
        return _kzg7594.verify_cell_proof_batch(
            [bytes(c) for c in row_commitments], [int(r) for r in row_ids],
            [int(c) for c in column_ids], [bytes(c) for c in cells], [bytes(p) for p in proofs],
            self.kzg_setup)

    # -- erasure recovery ----------------------------------------------------------

    def construct_vanishing_polynomial(self, missing_cell_ids):
        """Coefficients and full-domain evaluations of the polynomial that
        vanishes exactly on the missing cells' cosets."""
        num_cells = self.cells_per_blob()
        fe_per_cell = int(self.FIELD_ELEMENTS_PER_CELL)
        extended_width = 2 * self._width()
        roots_of_unity_reduced = self.compute_roots_of_unity(num_cells)
        short_zero_poly = self.vanishing_polynomialcoeff([
            roots_of_unity_reduced[self.reverse_bits(int(mid), num_cells)]
            for mid in missing_cell_ids])
        zero_poly_coeff = [0] * extended_width
        for i, coeff in enumerate(short_zero_poly):
            zero_poly_coeff[i * fe_per_cell] = coeff
        zero_poly_eval = self.fft_field(zero_poly_coeff,
                                        self.compute_roots_of_unity(extended_width))
        zero_poly_eval_brp = self.bit_reversal_permutation(zero_poly_eval)
        for cell_id in range(num_cells):
            cell = zero_poly_eval_brp[cell_id * fe_per_cell:(cell_id + 1) * fe_per_cell]
            if cell_id in missing_cell_ids:
                assert all(a == 0 for a in cell)
            else:
                assert all(a != 0 for a in cell)
        return zero_poly_coeff, zero_poly_eval

    def recover_polynomial(self, cell_ids, cells_bytes):
        """The full extended evaluations from any half of the cells: the
        batched recovery (``das/kernels.py``, K9 on the card)."""
        return _das.recover_cells_batch(
            [([int(c) for c in cell_ids], [bytes(cb) for cb in cells_bytes])],
            self.kzg_setup)[0]

    def recover_cells_and_kzg_proofs(self, cell_ids, cells_bytes):
        """Every cell recovered, and every cell's multiproof computed anew."""
        reconstructed_data = self.recover_polynomial(cell_ids, cells_bytes)
        fe_per_cell = int(self.FIELD_ELEMENTS_PER_CELL)
        width = self._width()
        recovered_cells = [reconstructed_data[i * fe_per_cell:(i + 1) * fe_per_cell]
                           for i in range(self.cells_per_blob())]
        coeffs = self.fft_field(self.bit_reversal_permutation(reconstructed_data),
                                self.compute_roots_of_unity(2 * width), inv=True)
        assert all(c == 0 for c in coeffs[width:])
        polynomial_coeff = coeffs[:width]
        recovered_proofs = []
        for i in range(self.cells_per_blob()):
            proof, ys = self.compute_kzg_proof_multi_impl(polynomial_coeff,
                                                          self.coset_for_cell(i))
            assert ys == recovered_cells[i]
            recovered_proofs.append(proof)
        return recovered_cells, recovered_proofs

    # -- custody and sidecars (das-core.md) ----------------------------------------

    def get_custody_columns(self, node_id, custody_subnet_count):
        """A hash walk from ``node_id`` to ``custody_subnet_count`` distinct
        subnets, each owning every DATA_COLUMN_SIDECAR_SUBNET_COUNT-th
        column."""
        assert int(custody_subnet_count) <= int(self.DATA_COLUMN_SIDECAR_SUBNET_COUNT)
        subnet_count = int(self.DATA_COLUMN_SIDECAR_SUBNET_COUNT)
        subnet_ids = []
        current_id = int(node_id)
        while len(subnet_ids) < int(custody_subnet_count):
            digest = hash(int(current_id).to_bytes(32, "little"))
            subnet_id = int.from_bytes(digest[0:8], "little") % subnet_count
            if subnet_id not in subnet_ids:
                subnet_ids.append(subnet_id)
            current_id = (current_id + 1) % 2**256
        columns_per_subnet = int(self.NUMBER_OF_COLUMNS) // subnet_count
        return sorted(ColumnIndex(subnet_count * i + subnet_id)
                      for i in range(columns_per_subnet) for subnet_id in subnet_ids)

    def signed_block_header(self, signed_block):
        """The signed header of a signed block (the sidecars carry it)."""
        block = signed_block.message
        return self.SignedBeaconBlockHeader(
            message=self.BeaconBlockHeader(
                slot=block.slot, proposer_index=block.proposer_index,
                parent_root=block.parent_root, state_root=block.state_root,
                body_root=hash_tree_root(block.body)),
            signature=signed_block.signature)

    def get_data_column_sidecars(self, signed_block, cells_and_proofs):
        """One DataColumnSidecar per column from a signed block's blob cells
        and proofs (``[(cells, proofs)]`` in commitment order)."""
        blob_kzg_commitments = signed_block.message.body.blob_kzg_commitments
        assert len(cells_and_proofs) == len(blob_kzg_commitments)
        signed_block_header = self.signed_block_header(signed_block)
        sidecars = []
        for column_index in range(int(self.NUMBER_OF_COLUMNS)):
            sidecars.append(self.DataColumnSidecar(
                index=column_index,
                column=[self.Cell(self.cell_to_bytes(cells[column_index]))
                        for cells, _ in cells_and_proofs],
                kzg_commitments=[KZGCommitment(bytes(c)) for c in blob_kzg_commitments],
                kzg_proofs=[KZGProof(bytes(proofs[column_index]))
                            for _, proofs in cells_and_proofs],
                signed_block_header=signed_block_header))
        return sidecars

    def verify_data_column_sidecar(self, sidecar) -> bool:
        """Structural validity: the index in range, a non-empty column, as
        many cells as commitments and proofs."""
        if int(sidecar.index) >= int(self.NUMBER_OF_COLUMNS):
            return False
        if len(sidecar.column) == 0:
            return False
        if not (len(sidecar.column) == len(sidecar.kzg_commitments)
                == len(sidecar.kzg_proofs)):
            return False
        return True

    def verify_data_column_sidecar_kzg_proofs(self, sidecar) -> bool:
        """Every cell of the column against its row commitment: one batch."""
        assert self.verify_data_column_sidecar(sidecar)
        return self.verify_cell_proof_batch(
            [bytes(c) for c in sidecar.kzg_commitments], list(range(len(sidecar.column))),
            [int(sidecar.index)] * len(sidecar.column), [bytes(cell) for cell in sidecar.column],
            [bytes(proof) for proof in sidecar.kzg_proofs])

    # -- availability by sampling ----------------------------------------------------

    def is_data_available(self, beacon_block_root, blob_kzg_commitments) -> bool:
        """The retrieved cells of each committed blob against their
        multiproofs, one batch a blob.  A ``retrieve_cells_and_proofs`` stub
        (``[(cell_ids, cells, proofs)]`` in commitment order) takes
        precedence; without one, Deneb's full-blob check."""
        retrieve = getattr(self, "retrieve_cells_and_proofs", None)
        if retrieve is None:
            return super().is_data_available(beacon_block_root, blob_kzg_commitments)
        sampled = retrieve(beacon_block_root)
        # a short return means data withheld, never availability
        if len(sampled) < len(blob_kzg_commitments):
            return False
        for commitment, (cell_ids, cells, proofs) in zip(blob_kzg_commitments, sampled):
            if not self.verify_cell_proof_batch([commitment], [0] * len(cell_ids), cell_ids,
                                                cells, proofs):
                return False
        return True

    # -- fork ladder and upgrade (fork.md) -------------------------------------------

    def compute_fork_version(self, epoch):
        e7594 = getattr(self.config, "EIP7594_FORK_EPOCH", None)
        if e7594 is not None and epoch >= e7594:
            return self.config.EIP7594_FORK_VERSION
        return super().compute_fork_version(epoch)

    def upgrade_to_eip7594(self, pre):
        """Deneb's layout, a new fork version: the state decoded from the
        pre-state's bytes, ``fork`` rotated."""
        post = self.BeaconState.decode_bytes(pre.serialize())
        post.fork = self.Fork(
            previous_version=pre.fork.current_version,
            current_version=self.config.EIP7594_FORK_VERSION,
            epoch=self.get_current_epoch(pre),
        )
        return post
