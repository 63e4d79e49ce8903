"""idle_share.train: percent of the traced slice's wall, between the
spins, in which no operation ran on the device."""


def read(rec):
    sl = rec.get("slice")
    if not sl or not sl["window_s"]:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
