from tec_mollm_tpu_torch.utils.logging import setup_logging
from tec_mollm_tpu_torch.utils.run_name import make_run_name

__all__ = ["make_run_name", "setup_logging"]
