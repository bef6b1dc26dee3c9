"""The launch cells' probes (``repro_torch.launch.cells``) whose
evaluation on the ``meta`` device costs a second or more, against
``jax.eval_shape`` of the reference's on the CPU, shape and dtype (single
pod, the meshes of ``launch_pairs.py``), for the dense and MoE archs: the
whole model's ``microbatch_vjp`` (1.5-2 s on meta for a dense arch) and
the MoE archs' layer probes (a loop over every mesh position).
``test_torch_launch_ssm_probes.py`` holds the SSM archs'.
"""
import pytest

torch = pytest.importorskip("torch")

from launch_pairs import (CELLS, SSM_ARCHS, pt_mesh,  # noqa: E402
                          probe_outputs_match, slow_on_meta)
from repro_torch.launch import cells as pt_cells  # noqa: E402


def _slow_labels(arch, shape):
    cell = pt_cells.build_cell(arch, shape, pt_mesh(False), False)
    return [p[0] for p in cell.probes
            if slow_on_meta(arch, shape, p[0])
            and not (arch in SSM_ARCHS and p[0] == "microbatch_vjp")]


SLOW = [(a, s) for a, s in CELLS
        if a not in SSM_ARCHS and _slow_labels(a, s)]


@pytest.mark.parametrize("arch,shape", SLOW, ids=[f"{a}-{s}"
                                                  for a, s in SLOW])
def test_slow_probe_outputs_match_eval_shape(arch, shape, forced_devices):
    forced_devices(8)
    probe_outputs_match(arch, shape, _slow_labels(arch, shape))
