"""Multi-agent DRQN with QMIX: the learner and the fused on-device trainer."""
