"""Host seconds of the port's ``FEMMesh`` (the P2 numbering, boundary and
its tables) in set-up."""


def read(record):
    return record["setup"].get("mesh_s")
