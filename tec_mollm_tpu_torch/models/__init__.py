from tec_mollm_tpu_torch.models.byte_lm import ByteLM, next_byte_loss, pretrain_model_config
from tec_mollm_tpu_torch.models.convert import byte_lm_params_to_state_dict, params_to_state_dict
from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs

__all__ = [
    "ByteLM",
    "TECMoLLM",
    "byte_lm_params_to_state_dict",
    "graph_inputs",
    "next_byte_loss",
    "params_to_state_dict",
    "pretrain_model_config",
]
