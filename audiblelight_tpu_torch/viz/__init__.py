from audiblelight_tpu_torch.viz.panorama import render_equirect_panorama

__all__ = ["render_equirect_panorama"]
