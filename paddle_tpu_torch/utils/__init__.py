"""Standalone user tools (reference: python/paddle/utils/ —
dump_config, plotcurve, merge_model, show_pb, image_util,
preprocess_img/preprocess_util, torch2paddle, make_model_diagram,
predefined_net, image_multiproc).  Each module is import-light and
runnable as ``python -m paddle_tpu_torch.utils.<tool>``."""
