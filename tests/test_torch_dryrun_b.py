"""PyTorch port, the dry run's reduced grid (``tests/test_torch_dryrun.py``'s
``test_run_cell_reduced_every_cell``) for its heaviest archs,
mamba2-780m and jamba-1.5-large-398b: every applicable shape on the
16x16 mesh, in a file of their own so that ``--dist loadfile`` runs them
beside the rest of the grid."""

import pytest

pytest.importorskip("torch")

from test_torch_dryrun import GRID_B, check_cell, grid  # noqa: E402


@pytest.mark.parametrize("arch,shape", grid(GRID_B))
def test_run_cell_reduced_every_cell_b(arch, shape):
    check_cell(arch, shape)
