from tec_mollm_tpu_torch.data.dataset import BatchLoader, SlidingWindowDataset, valid_window_starts
from tec_mollm_tpu_torch.data.scaler import StandardScaler

__all__ = ["BatchLoader", "SlidingWindowDataset", "StandardScaler", "valid_window_starts"]
