"""VPQ scoring, VIPER's evaluator and the unified panoptic artifacts (copies
of the JAX package's ``eval`` modules)."""

from vps_torch.eval.pq import PQStat  # noqa: F401
from vps_torch.eval.unified import (  # noqa: F401
    encode_panoptic_video,
    get_unified_pan_result,
    save_panoptic_outputs,
)
from vps_torch.eval.viper import (  # noqa: F401
    default_viper_categories,
    evaluate_panoptic_from_files,
    evaluate_panoptic_viper,
    viper_vpq_compute,
)
from vps_torch.eval.vpq import vpq_compute, vpq_eval_all  # noqa: F401
