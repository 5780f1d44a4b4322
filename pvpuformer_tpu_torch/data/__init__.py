"""The training data pipeline (pvpuformer_tpu/data): datasets, the click
sampler, augmentations, scribble synthesis and the batch `Loader`. numpy and
scipy only; it imports no torch."""
from .base import TrainSample, ISTrainDataset, SyntheticTrainDataset  # noqa: F401
from .points_sampler import MultiPointSampler  # noqa: F401
from .loader import Loader  # noqa: F401
from .cocolvis import (CocoLvisDataset, ImageDirTrainDataset,  # noqa: F401
                       SBDTrainDataset)
from . import transforms, scribbles  # noqa: F401
