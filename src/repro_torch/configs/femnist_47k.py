"""femnist-47k — the paper's own on-board client model (section 5):
47,887-parameter CNN for 47-way glyph classification (186 KB on the wire,
~98 MFLOP/epoch on 200-350 samples). Port of `repro.configs.femnist_47k`."""
from repro_torch.models.femnist_cnn import femnist_cnn_apply, femnist_cnn_init

CONFIG = {
    "kind": "femnist_cnn",
    "init": femnist_cnn_init,
    "apply": femnist_cnn_apply,
    "n_classes": 47,
    "input_shape": (28, 28, 1),
}
