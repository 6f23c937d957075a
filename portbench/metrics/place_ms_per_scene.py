"""Host clock of set-up's Scene API calls (the Scene, its microphone, its
events, its ambience), per ring scene."""


def read(run):
    return 1e3 * sum(run.place_s) / len(run.place_s) if run.place_s else None
