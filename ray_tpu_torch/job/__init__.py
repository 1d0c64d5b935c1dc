"""ray_tpu_torch.job — job submission: REST API + supervisor actors.

Reference: ``python/ray/dashboard/modules/job/`` — ``JobManager``
(``job_manager.py:59``) spawns a per-job ``JobSupervisor`` actor
(``job_supervisor.py:54``) that runs the entrypoint as a subprocess,
streams its logs, and drives PENDING → RUNNING → SUCCEEDED/FAILED/
STOPPED; clients speak REST via ``JobSubmissionClient`` (``sdk.py:125``).

    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient("http://127.0.0.1:8265")
    job_id = client.submit_job(entrypoint="python my_script.py")
    client.get_job_status(job_id)   # JobStatus.RUNNING ...
    print(client.get_job_logs(job_id))
"""

from ray_tpu_torch.job.manager import JobManager, JobStatus
from ray_tpu_torch.job.sdk import JobSubmissionClient
from ray_tpu_torch.job.server import start_job_server, stop_job_server

__all__ = [
    "JobManager",
    "JobStatus",
    "JobSubmissionClient",
    "start_job_server",
    "stop_job_server",
]
