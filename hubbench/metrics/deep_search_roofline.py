"""The quantized deep search's share of its roofline, in %: the least time
of the work of every call that returned within the traced window, computed
from its shapes (``peaks.deep_search_least_s``), over the device time of
everything the window ran on the device."""

from hubbench import peaks


def read(run):
    tr = run.trace
    config = run.cell.config
    if tr is None or tr.device_s <= 0 or config.get("storage_dtype") != "int8x2":
        return None
    least = sum(peaks.deep_search_least_s(len(c.asked), config["rows"], config["dims"])
                for c in tr.calls if c.answer is not None)
    return 100.0 * least / tr.device_s if least else None
