from revisit_anything_tpu_torch.utils.profiling import (  # noqa: F401
    StageTimer, stage_timer, trace)
from revisit_anything_tpu_torch.utils.seeding import (  # noqa: F401
    seed_everything)
