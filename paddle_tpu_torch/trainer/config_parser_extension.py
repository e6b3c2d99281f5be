"""Extra config functions injected into v1 config namespaces
(``paddle_tpu/trainer/config_parser_extension.py``): ``SimpleData``, the
'simple' data source as a plain config dict."""

g_config = None

__all__ = ["SimpleData", "get_config_funcs"]


def SimpleData(files=None, feat_dim=None, context_len=None,
               buffer_capacity=None):
    """The 'simple' data source config: a file list of
    whitespace-separated float rows."""
    return {
        "type": "simple",
        "files": files,
        "feat_dim": feat_dim,
        "context_len": context_len,
        "buffer_capacity": buffer_capacity,
    }


def get_config_funcs(trainer_config):
    global g_config
    g_config = trainer_config
    return dict(SimpleData=SimpleData)
