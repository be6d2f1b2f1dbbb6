// gpu-metricsd: the native metrics hostengine (the DCGM hostengine slot),
// native/tpu_metricsd.cpp's counterpart with the same flags and behaviour.
//
//   * the chip table from libgpuinfo (compiled in): NVML where it answers,
//     which gives each card's utilization, memory and temperature, else the
//     device nodes and sysfs; embedded verbatim under "chips" in /json;
//   * the card-owning sampler's side-file merged under "sample": only one
//     process may own the card's measurement (the Python sampler, which runs
//     a product on it), so this daemon reads what it dropped, and its "ts"
//     gates the age: an unstamped or stale sample is dropped, so a dead
//     sampler reads as missing and not as its last value forever;
//   * HTTP: /healthz, /json and /, /metrics (Prometheus text), 405 for a
//     method other than GET, 404 otherwise;
//   * the atomic drop file for file-based readers, its directory made first.
//
// /metrics carries the reference's series under the port's names (gpu_...),
// each with a `source` label that says where the number came from:
// "sampler" for the side-file's counters, "nvml" for NVML's readings and for
// presence NVML reports, "devfs" for presence from a device node, "sysfs" for
// the NUMA node. A card's counter comes from one source: the sampler's where
// it gave the key for that card, else NVML's.
//
// Plain POSIX sockets; a sequential accept loop (scrape traffic only).
//
//   gpu_metricsd [--port N] [--dev-root D] [--drop-file F] [--sample-file F]
//                [--interval S] [--sample-max-age S] [--once]
//                [--proc-root D] [--sysfs D]

#include <arpa/inet.h>
#include <netinet/in.h>
#include <poll.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

// C ABI from libgpuinfo.cpp (compiled into this binary).
extern "C" {
int gpuinfo_summary_json(const char* dev_root, const char* proc_root, const char* sysfs,
                         char* buf, int buf_len);
}

namespace {

std::atomic<bool> g_stop{false};

void on_signal(int) { g_stop = true; }

std::string read_file(const std::string& path, size_t max = 1 << 20) {
  FILE* f = std::fopen(path.c_str(), "r");
  if (!f) return "";
  std::string out;
  char buf[4096];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) {
    out.append(buf, n);
    if (out.size() > max) break;
  }
  std::fclose(f);
  while (!out.empty() && (out.back() == '\n' || out.back() == ' ')) out.pop_back();
  return out;
}

// The chip table as a JSON array ("[]" where the probe fails).
std::string chip_table(const std::string& dev_root, const std::string& proc_root,
                       const std::string& sysfs) {
  std::vector<char> buf(1 << 16);
  int rc;
  while ((rc = gpuinfo_summary_json(dev_root.c_str(), proc_root.c_str(), sysfs.c_str(),
                                    buf.data(), (int)buf.size())) == -3 &&
         buf.size() < (1u << 26))
    buf.resize(buf.size() * 4);
  return rc == 0 ? std::string(buf.data()) : "[]";
}

// Split a JSON array of flat objects into the objects' substrings (balanced
// braces; nested objects stay inside their parent). Per-object key lookups
// keep a card's counters with that card even where a key is present on only
// some cards; a positional key scan would misalign them.
std::vector<std::string> split_objects(const std::string& json) {
  std::vector<std::string> out;
  int depth = 0;
  size_t start = 0;
  bool in_string = false;
  for (size_t i = 0; i < json.size(); ++i) {
    char ch = json[i];
    if (in_string) {
      if (ch == '\\') ++i;
      else if (ch == '"') in_string = false;
      continue;
    }
    if (ch == '"') in_string = true;
    else if (ch == '{') {
      if (depth == 0) start = i;
      ++depth;
    } else if (ch == '}') {
      if (--depth == 0) out.push_back(json.substr(start, i - start + 1));
    }
  }
  return out;
}

// `"key":<number>` inside ONE flat object; nan when absent.
double find_number(const std::string& obj, const std::string& key) {
  std::string needle = "\"" + key + "\":";
  size_t pos = obj.find(needle);
  if (pos == std::string::npos) return std::nan("");
  return std::atof(obj.c_str() + pos + needle.size());
}

// `"key":"<string>"` inside ONE flat object; "" when absent.
std::string find_string(const std::string& obj, const std::string& key) {
  std::string needle = "\"" + key + "\":\"";
  size_t pos = obj.find(needle);
  if (pos == std::string::npos) return "";
  pos += needle.size();
  size_t end = obj.find('"', pos);
  return end == std::string::npos ? "" : obj.substr(pos, end - pos);
}

// The `"key":[...]` array substring of an object ("" when absent).
std::string extract_array(const std::string& json, const std::string& key) {
  std::string needle = "\"" + key + "\":";
  size_t pos = json.find(needle);
  if (pos == std::string::npos) return "";
  pos = json.find('[', pos + needle.size());
  if (pos == std::string::npos) return "";
  int depth = 0;
  bool in_string = false;
  for (size_t i = pos; i < json.size(); ++i) {
    char ch = json[i];
    if (in_string) {
      if (ch == '\\') ++i;
      else if (ch == '"') in_string = false;
      continue;
    }
    if (ch == '"') in_string = true;
    else if (ch == '[') ++depth;
    else if (ch == ']' && --depth == 0) return json.substr(pos, i - pos + 1);
  }
  return "";
}

// Prometheus text: each family's HELP and TYPE once, its samples together.
class Gauges {
 public:
  void set(const std::string& name, const std::string& help, const std::string& labels,
           double v) {
    // the shortest of 15 or 17 digits that reads back as v: byte counts
    // past 10 digits stay exact
    char num[64];
    std::snprintf(num, sizeof(num), "%.15g", v);
    if (std::strtod(num, nullptr) != v) std::snprintf(num, sizeof(num), "%.17g", v);
    std::string line = name + (labels.empty() ? "" : "{" + labels + "}") + " " + num + "\n";
    for (auto& f : families_)
      if (f.name == name) {
        f.lines += line;
        return;
      }
    families_.push_back({name, help, line});
  }
  std::string text() const {
    std::string out;
    for (const auto& f : families_)
      out += "# HELP " + f.name + " " + f.help + "\n# TYPE " + f.name + " gauge\n" + f.lines;
    return out;
  }

 private:
  struct Family {
    std::string name, help, lines;
  };
  std::vector<Family> families_;
};

// A sampler key, its series, and NVML's counter for the same quantity
// ("" where NVML has none).
struct Counter {
  const char* sampler_key;
  const char* series;
  const char* help;
  const char* nvml_key;
};
const Counter kCounters[] = {
    {"tensorcore_util", "gpu_tensorcore_utilization_percent",
     "Tensor-core utilization % (from the card-owning sampler)", ""},
    {"duty_cycle", "gpu_duty_cycle_percent", "Share of the last sample period a kernel ran, %",
     "utilization_gpu"},
    {"hbm_used", "gpu_memory_used_bytes", "Device memory in use, bytes", "memory_used_bytes"},
    {"hbm_total", "gpu_memory_total_bytes", "Device memory capacity, bytes",
     "memory_total_bytes"},
    {"temperature", "gpu_temperature_celsius", "Card temperature", "temperature_c"},
};

std::string chip_label(int chip_id, const char* source) {
  return "chip=\"" + std::to_string(chip_id) + "\",source=\"" + source + "\"";
}

struct Snapshot {
  std::string json;        // full /json body
  std::string prometheus;  // /metrics body
};

class Collector {
 public:
  Collector(std::string dev_root, std::string proc_root, std::string sysfs,
            std::string sample_file, std::string drop_file, double sample_max_age_s)
      : dev_root_(std::move(dev_root)),
        proc_root_(std::move(proc_root)),
        sysfs_(std::move(sysfs)),
        sample_file_(std::move(sample_file)),
        drop_file_(std::move(drop_file)),
        sample_max_age_s_(sample_max_age_s) {}

  void collect_once() {
    std::string chips = chip_table(dev_root_, proc_root_, sysfs_);
    std::vector<std::string> cards = split_objects(chips);
    std::string sample = read_file(sample_file_);
    bool have_sample = !sample.empty() && sample.front() == '{';
    double sample_age = -1;
    if (have_sample) {
      double ts = find_number(sample, "ts");
      if (std::isnan(ts)) {
        have_sample = false;  // un-ageable: rejected like a stale one
      } else {
        sample_age = (double)::time(nullptr) - ts;
        if (sample_age > sample_max_age_s_) have_sample = false;
      }
    }
    collections_++;

    std::string json = "{\"source\":\"gpu-metricsd-native\",\"ts\":" +
                       std::to_string((long)::time(nullptr)) +
                       ",\"chip_count\":" + std::to_string(cards.size()) + ",\"chips\":" + chips;
    if (have_sample) json += ",\"sample\":" + sample;
    json += "}";

    // the sampler's entries by card, each index as the entry names it (or
    // its position where it names none)
    std::vector<std::pair<int, std::string>> sampled;
    if (have_sample) {
      size_t si = 0;
      for (const std::string& entry : split_objects(extract_array(sample, "chips"))) {
        double idx = find_number(entry, "index");
        sampled.emplace_back(std::isnan(idx) ? (int)si : (int)idx, entry);
        ++si;
      }
    }
    auto sampler_has = [&sampled](int chip_id, const char* key) {
      for (const auto& s : sampled)
        if (s.first == chip_id && !std::isnan(find_number(s.second, key))) return true;
      return false;
    };

    Gauges g;
    g.set("gpu_metricsd_chips", "Cards in the chip table", "", (double)cards.size());
    g.set("gpu_metricsd_collections_total", "Collection passes", "", (double)collections_);
    g.set("gpu_metricsd_last_collect_ts_seconds", "Last collection time", "",
          (double)::time(nullptr));
    size_t pos = 0;
    for (const std::string& card : cards) {
      double idx = find_number(card, "index");
      int chip_id = std::isnan(idx) ? (int)pos : (int)idx;
      ++pos;
      bool nvml = find_string(card, "source") == "nvml";
      g.set("gpu_chip_present", "Card visible", chip_label(chip_id, nvml ? "nvml" : "devfs"), 1);
      double numa = find_number(card, "numa_node");
      if (!std::isnan(numa))
        g.set("gpu_chip_numa_node", "Card NUMA affinity", chip_label(chip_id, "sysfs"), numa);
      if (!nvml) continue;
      for (const Counter& c : kCounters) {
        double v = *c.nvml_key ? find_number(card, c.nvml_key) : std::nan("");
        if (!std::isnan(v) && !sampler_has(chip_id, c.sampler_key))
          g.set(c.series, c.help, chip_label(chip_id, "nvml"), v);
      }
    }
    if (sample_age >= 0)
      g.set("gpu_metricsd_sample_age_seconds", "Age of the sampler side-file", "", sample_age);
    g.set("gpu_metricsd_sample_fresh", "Sampler side-file present and fresh", "",
          have_sample ? 1 : 0);
    for (const auto& s : sampled)
      for (const Counter& c : kCounters) {
        double v = find_number(s.second, c.sampler_key);
        if (!std::isnan(v)) g.set(c.series, c.help, chip_label(s.first, "sampler"), v);
      }

    {
      std::lock_guard<std::mutex> lock(mu_);
      snap_.json = json;
      snap_.prometheus = g.text();
    }
    write_drop_file(json);
  }

  Snapshot snapshot() {
    std::lock_guard<std::mutex> lock(mu_);
    return snap_;
  }

 private:
  void write_drop_file(const std::string& payload) {
    if (drop_file_.empty()) return;
    size_t slash = drop_file_.find_last_of('/');
    if (slash != std::string::npos && slash > 0) {
      std::string dir = drop_file_.substr(0, slash);  // mkdir -p, no system()
      for (size_t i = 1; i <= dir.size(); ++i) {
        if (i == dir.size() || dir[i] == '/') ::mkdir(dir.substr(0, i).c_str(), 0755);
      }
    }
    std::string tmp = drop_file_ + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "w");
    if (!f) return;
    std::fwrite(payload.data(), 1, payload.size(), f);
    std::fclose(f);
    std::rename(tmp.c_str(), drop_file_.c_str());
  }

  std::string dev_root_, proc_root_, sysfs_, sample_file_, drop_file_;
  double sample_max_age_s_;
  std::mutex mu_;
  Snapshot snap_;
  long collections_ = 0;
};

void respond(int fd, const char* status, const std::string& content_type,
             const std::string& body) {
  std::string msg = "HTTP/1.1 " + std::string(status) + "\r\nContent-Type: " + content_type +
                    "\r\nContent-Length: " + std::to_string(body.size()) +
                    "\r\nConnection: close\r\n\r\n" + body;
  size_t sent = 0;
  while (sent < msg.size()) {
    ssize_t n = ::write(fd, msg.data() + sent, msg.size() - sent);
    if (n <= 0) return;
    sent += (size_t)n;
  }
}

void handle(int fd, Collector& collector) {
  char req[2048];
  ssize_t n = ::read(fd, req, sizeof(req) - 1);
  if (n <= 0) return;
  req[n] = '\0';
  char method[8] = {0}, path[256] = {0};
  std::sscanf(req, "%7s %255s", method, path);
  if (std::strcmp(method, "GET") != 0) {
    respond(fd, "405 Method Not Allowed", "text/plain", "GET only\n");
    return;
  }
  Snapshot snap = collector.snapshot();
  if (std::strcmp(path, "/healthz") == 0) {
    respond(fd, "200 OK", "text/plain", "ok\n");
  } else if (std::strcmp(path, "/metrics") == 0) {
    respond(fd, "200 OK", "text/plain; version=0.0.4", snap.prometheus);
  } else if (std::strcmp(path, "/") == 0 || std::strcmp(path, "/json") == 0) {
    respond(fd, "200 OK", "application/json", snap.json);
  } else {
    respond(fd, "404 Not Found", "text/plain", "not found\n");
  }
}

}  // namespace

int main(int argc, char** argv) {
  std::string dev_root = "/dev";
  std::string proc_root, sysfs;  // "" reads the host's
  std::string drop_file = "/run/tpu/metricsd.json";
  std::string sample_file = "/run/tpu/metricsd-sample.json";
  int port = 5555;
  double interval_s = 10.0;
  double sample_max_age_s = 60.0;
  bool once = false;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> const char* { return i + 1 < argc ? argv[++i] : ""; };
    if (a == "--dev-root") dev_root = next();
    else if (a == "--proc-root") proc_root = next();
    else if (a == "--sysfs") sysfs = next();
    else if (a == "--drop-file") drop_file = next();
    else if (a == "--sample-file") sample_file = next();
    else if (a == "--port") port = std::atoi(next());
    else if (a == "--interval") interval_s = std::atof(next());
    else if (a == "--sample-max-age") sample_max_age_s = std::atof(next());
    else if (a == "--once") once = true;
    else if (a == "--help" || a == "-h") {
      std::printf(
          "gpu-metricsd [--port N] [--dev-root D] [--drop-file F]\n"
          "             [--sample-file F] [--interval S] [--sample-max-age S] [--once]\n"
          "             [--proc-root D] [--sysfs D]\n");
      return 0;
    }
  }

  Collector collector(dev_root, proc_root, sysfs, sample_file, drop_file, sample_max_age_s);
  collector.collect_once();
  if (once) {
    std::printf("%s\n", collector.snapshot().json.c_str());
    return 0;
  }

  // no SA_RESTART: a signal ends the poll below at once
  struct sigaction sa {};
  sa.sa_handler = on_signal;
  ::sigaction(SIGINT, &sa, nullptr);
  ::sigaction(SIGTERM, &sa, nullptr);
  ::signal(SIGPIPE, SIG_IGN);

  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv < 0) {
    std::perror("socket");
    return 1;
  }
  int opt = 1;
  ::setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &opt, sizeof(opt));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(srv, (sockaddr*)&addr, sizeof(addr)) != 0) {
    std::perror("bind");
    return 1;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(srv, (sockaddr*)&addr, &len);  // resolves --port 0
  if (::listen(srv, 16) != 0) {
    std::perror("listen");
    return 1;
  }
  std::printf("gpu-metricsd listening on port %d (dev-root %s)\n", (int)ntohs(addr.sin_port),
              dev_root.c_str());
  std::fflush(stdout);

  std::thread loop([&] {
    while (!g_stop) {
      collector.collect_once();
      for (double waited = 0; waited < interval_s && !g_stop; waited += 0.05)
        ::usleep(50 * 1000);
    }
  });

  // poll with a timeout, so a stop is seen within 200 ms without a request
  while (!g_stop) {
    pollfd p{srv, POLLIN, 0};
    if (::poll(&p, 1, 200) <= 0) continue;
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    handle(fd, collector);
    ::close(fd);
  }
  ::close(srv);
  loop.join();
  return 0;
}
