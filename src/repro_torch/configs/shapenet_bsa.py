"""The paper's own model: 18-block BSA point-cloud regressor (ShapeNet-Car).

Counterpart of ``repro/configs/shapenet_bsa.py``: ball 256, ℓ = 8, top-k 4,
group 8 (Appendix A); d_model 256, 8 heads of 32, SwiGLU d_ff 1024, fp32.
ShapeNet-Car has 3586 points → padded to 3840 = 15 balls of 256.  Only the
BSA variants are ported; ``shapenet-bsa-group-cmp`` (φ = "mlp") and the
full / Erwin baselines come with later slices.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import PAPER_BSA


def _base(**kw) -> ModelConfig:
    d = dict(
        name="shapenet-bsa", family="pointcloud", n_layers=18, d_model=256,
        n_heads=8, n_kv_heads=8, head_dim=32, d_ff=1024,
        in_dim=7, out_dim=1, attention="bsa", bsa=PAPER_BSA,
        param_dtype="float32", compute_dtype="float32")
    d.update(kw)
    return ModelConfig(**d)


@register("shapenet-bsa")
def config() -> ModelConfig:
    return _base()


@register("shapenet-bsa-no-group")
def config_no_group() -> ModelConfig:
    bsa = dataclasses.replace(PAPER_BSA, group_size=0, query_cmp_selection=False)
    return _base(name="shapenet-bsa-no-group", bsa=bsa)


@register("elasticity-bsa")
def config_elasticity() -> ModelConfig:
    # Elasticity benchmark: 972 points → padded to 1024 = 4 balls of 256
    return _base(name="elasticity-bsa", in_dim=6)
