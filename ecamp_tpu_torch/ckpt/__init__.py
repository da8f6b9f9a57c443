from .checkpoint import (checkpoint_path, load_checkpoint, load_model_state,
                         save_checkpoint)
from .convert import (import_vit_classifier, load_classifier_state,
                      load_reference_pth, state_dict_from_flax)

__all__ = ["checkpoint_path", "load_checkpoint", "load_model_state",
           "save_checkpoint", "import_vit_classifier",
           "load_classifier_state", "load_reference_pth",
           "state_dict_from_flax"]
