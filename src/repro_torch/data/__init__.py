"""data of the PyTorch port (mirrors repro.data)."""

from repro_torch.data.elasticity import ElasticityDataset
from repro_torch.data.lm import lm_batches
from repro_torch.data.shapenet import ShapeNetCarDataset

__all__ = ["ShapeNetCarDataset", "ElasticityDataset", "lm_batches"]
