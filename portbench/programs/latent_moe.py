"""``model`` "latent_moe": the port's ``LatentMoe``
(``spmm_tpu_torch/models/latent_moe.py``, DeepSeek-V3's layout)."""


def build(config: dict):
    from spmm_tpu_torch.configs import LatentMoeConfig
    from spmm_tpu_torch.models.latent_moe import LatentMoe

    return LatentMoe(LatentMoeConfig.from_dict(config))
