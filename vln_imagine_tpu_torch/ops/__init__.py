from vln_imagine_tpu_torch.ops.angles import (
    all_point_angle_feature,
    angle_feature,
    view_elevation,
    view_heading,
)
from vln_imagine_tpu_torch.ops.masks import (
    NEG_INF_MASK,
    extend_neg_mask,
    length_to_mask,
    masked_softmax,
)

# the op modules that declare the C entries of ops/kernels.py, so that its
# launch_counts() knows every wrapper whichever module was imported first
from vln_imagine_tpu_torch.ops import attention, layer_norm  # noqa: F401
