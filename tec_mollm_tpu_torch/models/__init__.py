from tec_mollm_tpu_torch.models.convert import params_to_state_dict
from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs

__all__ = ["TECMoLLM", "graph_inputs", "params_to_state_dict"]
