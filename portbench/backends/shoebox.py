"""The shoebox backend's settings: the scene's room, the configuration's
absorption, image order and IR length, and the world state's seed."""


def backend_kwargs(config: dict, spec: dict) -> dict:
    eng = config["engine"]
    return dict(dimensions=spec["room"], absorption=eng["absorption"], max_order=eng["max_order"],
                max_ir_length=eng["max_ir_length"], seed=spec["state_seed"])
