"""launcher.other_s: mean seconds of a job outside its steps (argument
parsing, logging set-up, manifests, step dirs): the job's wall time, by
the harness's clock around cli.main, less its steps' "done in" records."""


def read(rec):
    done = [j for j in rec.jobs if j.rc == 0 and j.steps]
    if not done:
        return None
    return sum(j.wall_s - sum(j.steps.values()) for j in done) / len(done)
