"""The check catches a broken timed path: each run drives a cell's driver
on the CPU at a tiny size with a fault planted under it, and `correct`
comes out false: a step that returns its state unchanged, half of the batch
left out (the mean of the rest in its place), an answer altered where it is
produced: on every lane, and on a quarter of the lanes (or of the robot's
episodes) alone, which a median over the answers would let pass; and the
people the social solve reads moved by 5 cm, which alters only the lanes
with a person in view. (One card needs no exchange between cards to leave
out. In the obstacle cell the float64 reference stops on a saddle on
straight plans, so its command check holds only a fault on about half the
lanes or more; a quarter is the social cells' to catch, PERF.md.)"""

import pytest
import torch

from portbench.tests.rehearsal import rehearse

SEED = 2**31 + 29


def _mean_of_first_half(x):
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    half = x.shape[0] // 2
    x = x.clone()
    if x.is_floating_point():
        x[half:] = x[:half].mean(dim=0)
    else:
        x[half:] = x[0]
    return x


def _tree(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree(fn, v) for v in tree))
    return fn(tree)


def fleet_state_unchanged(driver):
    step = driver.step
    driver.step = lambda sc, carry: step(sc, carry)[:2] + (carry,)


def fleet_half_batch(driver):
    step = driver.step
    driver.step = lambda sc, carry: tuple(_tree(_mean_of_first_half, o) for o in step(sc, carry))


def fleet_answer_altered(driver):
    step = driver.step

    def run(sc, carry):
        cmd, aux, new = step(sc, carry)
        return cmd._replace(angular_z=cmd.angular_z + 0.01), aux, new
    driver.step = run


def _quarter(x):
    """0.05 on every fourth lane of a batch of commands, 0 elsewhere."""
    return 0.05 * (torch.arange(x.shape[0], device=x.device) % 4 == 0).to(x.dtype)


def fleet_quarter_altered(driver):
    step = driver.step

    def run(sc, carry):
        cmd, aux, new = step(sc, carry)
        return cmd._replace(angular_z=cmd.angular_z + _quarter(cmd.angular_z)), aux, new
    driver.step = run


def _people_moved(sc):
    state = sc.people.state.clone()
    state[..., 0] += 0.05
    return sc._replace(people=sc.people._replace(state=state))


def fleet_people_moved(driver):
    step = driver.step
    driver.step = lambda sc, carry: step(_people_moved(sc), carry)


def robot_state_unchanged(driver):
    step = driver.ctrl._step
    driver.ctrl._step = lambda sc, carry: step(sc, carry)[:2] + (carry,)


def robot_answer_altered(driver):
    step = driver.ctrl._step

    def run(sc, carry):
        cmd, aux, new = step(sc, carry)
        return cmd._replace(angular_z=cmd.angular_z + 0.01), aux, new
    driver.ctrl._step = run


def robot_quarter_altered(driver):
    step = driver.ctrl._step

    def run(sc, carry):
        cmd, aux, new = step(sc, carry)
        if (driver.t // driver.episode) % 4 == 0:
            cmd = cmd._replace(angular_z=cmd.angular_z + 0.05)
        return cmd, aux, new
    driver.ctrl._step = run


def campaign_state_unchanged(driver):
    run = driver.sim.run_batch

    def frozen(scen):
        res = run(scen)
        return res._replace(robot_traj=res.robot_traj[:, :1].expand_as(res.robot_traj).clone(),
                            people_traj=res.people_traj[:, :1].expand_as(
                                res.people_traj).clone())
    driver.sim.run_batch = frozen


def campaign_half_batch(driver):
    run = driver.sim.run_batch
    driver.sim.run_batch = lambda scen: _tree(_mean_of_first_half, run(scen))


def campaign_quarter_altered(driver):
    run = driver.sim.run_batch

    def altered(scen):
        res = run(scen)
        return res._replace(cmds=res.cmds + torch.stack(
            [torch.zeros(res.cmds.shape[0]), _quarter(res.cmds[:, 0, 1])], -1)[:, None])
    driver.sim.run_batch = altered


def campaign_answer_altered(driver):
    run = driver.sim.run_batch

    def altered(scen):
        res = run(scen)
        return res._replace(cmds=res.cmds + torch.tensor([0.0, 0.01]))
    driver.sim.run_batch = altered


@pytest.mark.parametrize("cell,fault", [
    ("social.fleet4096", fleet_state_unchanged),
    ("social.fleet4096", fleet_half_batch),
    ("social.fleet4096", fleet_answer_altered),
    ("social.fleet4096", fleet_quarter_altered),
    ("social.fleet4096", fleet_people_moved),
    ("obstacle.fleet4096", fleet_state_unchanged),
    ("obstacle.fleet4096", fleet_half_batch),
    ("obstacle.fleet4096", fleet_answer_altered),
    ("social.robot1", robot_state_unchanged),
    ("social.robot1", robot_answer_altered),
    ("social.robot1", robot_quarter_altered),
    ("social.campaign4096", campaign_state_unchanged),
    ("social.campaign4096", campaign_half_batch),
    ("social.campaign4096", campaign_answer_altered),
    ("social.campaign4096", campaign_quarter_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault):
    _, numbers, ok = rehearse(cell, SEED, fault)
    assert not ok, numbers.values()
