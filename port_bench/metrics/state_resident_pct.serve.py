"""The share of the process's ``predict``/``predict_many`` requests whose
sessions' ConvLSTM states went to the step as the serving engine holds
them, one batch a geometry, with no gather or write-back of rows: 100 ×
resident / (resident + gathered), from the port's own counters
(``serve.state_counts``). The counters cover the whole process, not the
timed window alone: the warm-up's requests and those served after the
window to finish the checked runs count too. None where the port keeps
no such counters."""


def read(view):
    if view.kind != "serve":
        return None
    try:
        from unet_convlstm_tpu_torch.serve import state_counts
    except ImportError:             # a port that counts no state paths
        return None
    c = state_counts()
    n = c["resident"] + c["gathered"]
    return 100.0 * c["resident"] / n if n else None
