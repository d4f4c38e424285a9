"""Dataset image listings and ground truth (counterpart of
``revisit_anything_tpu/datasets``); host-side numpy and scipy only."""

from revisit_anything_tpu_torch.datasets.gt import (  # noqa: F401
    get_gt, parse_camera_pose, radius_positives, utm_from_paths)
from revisit_anything_tpu_torch.datasets.images import (  # noqa: F401
    list_dataset_images)
