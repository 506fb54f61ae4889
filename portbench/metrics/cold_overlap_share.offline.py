"""The cold path's overlap, in percent: the per-batch stage, run and
fetch seconds summed, less the calls' ``total_s``, over that sum."""


def read(layer):
    o = layer["offline"]
    if not o["routed_cold"] or not o["cold_phases_s"]:
        return None
    return 100.0 * (o["cold_phases_s"] - o["cold_total_s"]) / \
        o["cold_phases_s"]
