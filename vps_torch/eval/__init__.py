"""VPQ scoring and the unified panoptic artifacts (copies of the JAX
package's ``eval`` modules)."""

from vps_torch.eval.pq import PQStat  # noqa: F401
from vps_torch.eval.unified import (  # noqa: F401
    encode_panoptic_video,
    get_unified_pan_result,
    save_panoptic_outputs,
)
from vps_torch.eval.vpq import vpq_compute, vpq_eval_all  # noqa: F401
