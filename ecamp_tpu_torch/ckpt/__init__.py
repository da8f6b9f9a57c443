from .convert import (load_classifier_state, load_reference_pth,
                      state_dict_from_flax)

__all__ = ["load_classifier_state", "load_reference_pth",
           "state_dict_from_flax"]
