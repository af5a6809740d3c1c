"""Shared aid of the port's KZG and DAS tests: a small trusted setup built
from a KNOWN tau.  Test-only and insecure by construction (anyone who
knows tau can forge proofs); it exists so the Deneb library and the DAS
batch can run at widths 8 and 64, where the plain kernels take seconds
on a CPU instead of the minutes the real 4096-point setup would take.

Both packages read a setup through the same attributes, so one point
list serves both; each package gets its own object so that ``g2_tau``
is that package's oracle point."""
from consensus_specs_tpu.ops import kzg as JK
from consensus_specs_tpu.ops import native_bls
from consensus_specs_tpu.ops.bls12_381.curve import G1_GENERATOR, G2_GENERATOR

R = JK.BLS_MODULUS
TAU = 0x2F1D_A5E3_77C1_0B4D_91E6_5A13_C0DE_F00D_1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321 % R


class Setup:
    """Duck-typed stand-in for ``TrustedSetup``."""

    def __init__(self, points, g2_from_compressed):
        g1_mono, g1_lag, g2_mono = points
        self.KZG_SETUP_G1_MONOMIAL = g1_mono
        self.KZG_SETUP_G1_LAGRANGE = g1_lag
        self.KZG_SETUP_G2_MONOMIAL = g2_mono
        self.FIELD_ELEMENTS_PER_BLOB = len(g1_lag)
        self.g1_lagrange_brp = JK.bit_reversal_permutation(g1_lag)
        self.g2_tau = g2_from_compressed(g2_mono[1])


def setup_points(width: int, n_g2: int):
    """Compressed [tau^i]G1 (i < width), the Lagrange basis
    [L_i(tau)]G1 over the natural-order roots w^i with
    L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i)), and [tau^i]G2
    (i < n_g2), by the JAX package's native scalar multiplication."""
    g1, g2 = G1_GENERATOR.to_compressed(), G2_GENERATOR.to_compressed()
    roots = JK.compute_roots_of_unity(width)
    num = (pow(TAU, width, R) - 1) % R
    lag = [w * num * pow(width * (TAU - w), -1, R) % R for w in roots]
    return ([native_bls.g1_msm_compressed([g1], [pow(TAU, i, R)]) for i in range(width)],
            [native_bls.g1_msm_compressed([g1], [s]) for s in lag],
            [native_bls.g2_msm_compressed([g2], [pow(TAU, i, R)]) for i in range(n_g2)])


def blob(rng, width: int) -> bytes:
    """A blob of ``width`` canonical field elements from a numpy Generator."""
    return b"".join((int.from_bytes(rng.bytes(32), "big") % R).to_bytes(32, "big")
                    for _ in range(width))
