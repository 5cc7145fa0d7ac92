"""More kernel-vs-`while` frame cases (split from test_pallas.py so the
test workers share the interpreter's cost): a ragged frame size, no
skybox, and supersampling, bitwise on the uint8 frame."""

import numpy as np
import pytest

from tests.kernel_cases import kernel_and_while_frames


@pytest.mark.parametrize("name", ["non_pow2", "no_sky", "supersample2"])
def test_kernel_frame_equals_while(name):
    got, want, (h, w) = kernel_and_while_frames(name, block=(8, 16))
    assert got.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)
