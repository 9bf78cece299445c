"""launches.serve (launches, program_counter): kernel launches a dispatch, summed
over the port's kernel wrappers' ``.launches`` counters in the untraced window."""


def read(record):
    total = sum(record["launches"].values()) if record.get("kind") == "serve" else 0
    return total / record["calls"] if total and record["calls"] else None
