"""utils.profiling's trace reduction (device time per named scope, busy
share) on a small hand-written trace and HLO text."""

import jax
import pytest

from ebcc_tpu.codec.pipeline import SCOPES, SCOPE_MASK, SCOPE_RESID, \
    SCOPE_TRUNC
from ebcc_tpu.utils import profiling

HLO = """
HloModule jit_encode
%fused_computation.1 (p: f32[4]) -> f32[4] {
  ROOT %m = f32[4]{0} multiply(%p, %p), metadata={op_name="jit(f)/ebcc_trunc_search/mul"}
}
ENTRY %main {
  %loop_multiply_fusion.3 = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_computation.1, metadata={op_name="jit(f)/ebcc_trunc_search/mul"}
  %sort.2 = f32[4]{0} sort(%y), dimensions={0}, metadata={op_name="jit(f)/ebcc_resid_pack/ebcc_mask_search/sort"}
  %copy-start.1 = f32[4]{0} copy(%z), metadata={op_name="jit(f)/ebcc_resid_pack/copy"}
  ROOT %add.9 = f32[4]{0} add(%a, %b), metadata={op_name="jit(f)/add"}
}
"""

# one device stream: a trunc kernel (by name), a mask kernel (by its
# hlo_op stat), a resid kernel, an unknown kernel overlapping the first,
# and a kernel outside the host window; plus a derived summary line
TRACE = """
planes {
  id: 1 name: "/device:GPU:0"
  lines {
    id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000 }
    events { metadata_id: 2 offset_ps: 5000000 duration_ps: 2000000
             stats { metadata_id: 1 str_value: "sort.2" } }
    events { metadata_id: 3 offset_ps: 8000000 duration_ps: 1000000 }
    events { metadata_id: 5 offset_ps: 50000000 duration_ps: 1000000 }
  }
  lines {
    id: 2 name: "Stream #14(Compute)" timestamp_ns: 1000
    events { metadata_id: 4 offset_ps: 1000000 duration_ps: 2000000 }
  }
  lines {
    id: 3 name: "XLA Ops" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_multiply_fusion_3" } }
  event_metadata { key: 2 value { id: 2 name: "cub_radix_sort_kernel" } }
  event_metadata { key: 3 value { id: 3 name: "copy_start_1" } }
  event_metadata { key: 4 value { id: 4 name: "some_other_kernel" } }
  event_metadata { key: 5 value { id: 5 name: "loop_multiply_fusion_3" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_op" } }
}
planes {
  id: 2 name: "/host:CPU"
  lines {
    id: 1 name: "python" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 10000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "window" } }
}
"""


def test_hlo_scopes_innermost_and_kernel_names():
    names = profiling.hlo_scopes(HLO, SCOPES)
    assert names["loop_multiply_fusion.3"] == SCOPE_TRUNC
    assert names["loop_multiply_fusion_3"] == SCOPE_TRUNC
    assert names["sort.2"] == SCOPE_MASK  # innermost of the two scopes
    assert names["copy_start_1"] == SCOPE_RESID
    assert "add.9" not in names


@pytest.mark.parametrize("window", ["window", None])
def test_device_time_by_scope(window):
    profile = jax.profiler.ProfileData.from_text_proto(TRACE)
    red = profiling.device_time_by_scope(
        profile, profiling.hlo_scopes(HLO, SCOPES), window=window)
    assert red["by_scope"] == {SCOPE_TRUNC: 4000.0 + (0 if window else
                                                      1000.0),
                               SCOPE_MASK: 2000.0, SCOPE_RESID: 1000.0}
    assert red["unattributed_ns"] == 2000.0
    if window:
        # kernels 1000..10000 ns inside a 10000 ns host span; the two
        # streams overlap for 2000 ns
        assert red["n_events"] == 4
        assert red["kernel_ns"] == 9000.0
        assert red["busy_ns"] == 7000.0
        assert red["window_ns"] == 10000.0
    else:
        assert red["n_events"] == 5
        assert red["window_ns"] == 51000.0  # first start to last end


def test_missing_window_is_an_error():
    profile = jax.profiler.ProfileData.from_text_proto(TRACE)
    with pytest.raises(ValueError, match="no host span"):
        profiling.device_time_by_scope(profile, {}, window="absent")
