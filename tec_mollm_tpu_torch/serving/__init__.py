from tec_mollm_tpu_torch.serving.server import ForecastService, make_server, serve

__all__ = ["ForecastService", "make_server", "serve"]
