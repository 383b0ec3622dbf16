"""What a worker process of the check runs: the reference over one sampled
lane. Imports NumPy and the reference only."""

from portbench.reference import tick


def run(job: dict):
    """The job's kind ("controller" or "world") on the job."""
    return globals()[job["kind"]](job)


def controller(job: dict):
    """The reference's ticks of one lane's episode (tick.episode), in
    float64 or, with job["control"], in bfloat16."""
    return tick.episode(job["config"], job["lane"], job["poses"], job.get("speeds"),
                        job.get("people"), control=job.get("control", False),
                        judge=job.get("judge"))


def world(job: dict):
    """The world update of each tick of one lane's campaign from the state
    the job gives (tick.world_update); bfloat16-rounded with
    job["control"]."""
    out = []
    for pose, speed, people, cmd in zip(job["poses"], job["speeds"], job["people"], job["cmds"]):
        new = tick.world_update(job["config"], job["lane"], pose, speed, people, cmd, job["dt"])
        out.append(tuple(tick.bf16(x) for x in new) if job.get("control") else new)
    return out
