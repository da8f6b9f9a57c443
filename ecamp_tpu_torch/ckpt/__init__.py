from .checkpoint import (checkpoint_path, load_checkpoint, load_model_state,
                         save_checkpoint)
from .convert import (import_detector, import_ecamp_pretrain,
                      import_resnet_unet, import_seg_vit,
                      import_vit_classifier, load_reference_pth,
                      load_reference_state, pretrain_state,
                      state_dict_from_flax)

__all__ = ["checkpoint_path", "load_checkpoint", "load_model_state",
           "save_checkpoint", "import_detector", "import_ecamp_pretrain",
           "import_resnet_unet",
           "import_seg_vit",
           "import_vit_classifier", "load_reference_pth",
           "load_reference_state", "pretrain_state",
           "state_dict_from_flax"]
