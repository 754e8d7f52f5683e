"""Golden-file regression parity with the reference (reference C13).

Reproduces the reference's own regression harnesses:
  - single-level LK vs U2Test.txt / V2Test.txt (serialOrig.cpp:575-636),
  - 7-level pyramidal LK vs UPyrTest.txt / VPyrTest.txt
    (SerialPyr.cpp:261-319),
both on table1/table2 cropped to 640x448 and scaled by 1/255.

In float64 the framework matches the goldens at the text-file precision
(%lf keeps 6 decimals -> max error 5e-7), i.e. at the reference's own 1e-6
regression threshold. In float32 (the production dtype on the device) the mean
endpoint error must stay within the 0.1px budget (BASELINE.md).
"""

import numpy as np
import pytest

import jax

from optical_flow_tpu.flow.lk import lucas_kanade
from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine
from optical_flow_tpu.utils.goldens import load_mat


GOLDEN_TOL = 1e-6  # the reference's own threshold (serialOrig.cpp:588)


@pytest.fixture(scope="module")
def goldens_single(reference_dir):
    return load_mat(reference_dir / "U2Test.txt"), load_mat(reference_dir / "V2Test.txt")


@pytest.fixture(scope="module")
def goldens_pyr(reference_dir):
    return load_mat(reference_dir / "UPyrTest.txt"), load_mat(reference_dir / "VPyrTest.txt")


def _epe(u, v, gu, gv):
    return float(np.mean(np.hypot(np.asarray(u) - gu, np.asarray(v) - gv)))


class TestSingleLevelGolden:
    def test_f64_exact(self, table_pair, goldens_single):
        img1, img2 = table_pair
        u, v = jax.jit(lucas_kanade)(img1, img2)
        gu, gv = goldens_single
        assert np.abs(np.asarray(u) - gu).max() <= GOLDEN_TOL
        assert np.abs(np.asarray(v) - gv).max() <= GOLDEN_TOL

    def test_f32_epe_budget(self, table_pair, goldens_single):
        img1, img2 = table_pair
        u, v = jax.jit(lucas_kanade)(img1.astype(np.float32), img2.astype(np.float32))
        gu, gv = goldens_single
        assert _epe(u, v, gu, gv) <= 0.1


class TestPyramidalGolden:
    def test_f64_exact(self, table_pair, goldens_pyr):
        img1, img2 = table_pair
        u, v = jax.jit(lambda a, b: coarse_to_fine(a, b, 7))(img1, img2)
        gu, gv = goldens_pyr
        assert np.abs(np.asarray(u) - gu).max() <= GOLDEN_TOL
        assert np.abs(np.asarray(v) - gv).max() <= GOLDEN_TOL

    def test_f32_epe_budget(self, table_pair, goldens_pyr):
        img1, img2 = table_pair
        u, v = jax.jit(lambda a, b: coarse_to_fine(a, b, 7))(
            img1.astype(np.float32), img2.astype(np.float32)
        )
        gu, gv = goldens_pyr
        assert _epe(u, v, gu, gv) <= 0.1

    def test_default_levels_match_reference(self, table_pair, goldens_pyr):
        # levels=None must resolve to getMaxLayer's 7 for 640x448
        img1, img2 = table_pair
        u, v = coarse_to_fine(img1, img2)
        gu, gv = goldens_pyr
        assert np.abs(np.asarray(u) - gu).max() <= GOLDEN_TOL
